"""No module a run imports is jax's or the JAX package's, compared by
whole top-level names; the reference stands without the port."""

import subprocess
import sys
import textwrap

from pbench import spec

RUN = str(spec.BENCH_DIR / "run.py")


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_run_imports_no_jax():
    """Every module of the harness, the metric readers and the port's
    replay path imported in one process: none is forbidden."""
    out = _python(f"""
        import runpy, sys
        run = runpy.run_path({RUN!r})
        sys.path[:0] = [{str(spec.BENCH_DIR)!r}, {str(spec.ROOT)!r}]
        from pbench import cell, check, cost, gen, spans, spec, trace
        from pbench.reference import pipeline
        import loam_tpu_torch.parallel.replay
        for m in spec.benchmark()["per_layer"]:
            spec.metric_reader(m["name"])
        print(run["forbidden_modules"](), "loam_tpu_torch" in sys.modules)
    """)
    assert out.split() == ["[]", "True"]


def test_forbidden_names_compare_whole():
    out = _python(f"""
        import runpy, sys, types
        run = runpy.run_path({RUN!r})
        sys.modules["loam_tpu_torch_x"] = types.ModuleType("x")
        before = run["forbidden_modules"]()
        sys.modules["loam_tpu.ops"] = types.ModuleType("y")
        print(before, run["forbidden_modules"]())
    """)
    assert out.strip() == "[] ['loam_tpu']"


def test_reference_runs_without_the_port():
    """The frozen reference with loam_tpu_torch and tests/ made
    unimportable, on a generated sweep pair."""
    out = _python(f"""
        import sys, importlib.abc
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("loam_tpu_torch", "loam_tpu",
                                          "golden", "oracles", "jax"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path = [p for p in sys.path if p not in ("", ".",
                    {str(spec.ROOT)!r})]
        sys.path.insert(0, {str(spec.BENCH_DIR)!r})
        import numpy as np, torch
        from pbench import gen
        from pbench.reference.pipeline import run_pipeline
        traffic = dict(scenarios=1, frames=3, pillars=6, boxes=4,
                       speed_mps=[1.0, 1.0], yaw_rate_rps=[0.0, 0.0],
                       range_noise_m=0.005)
        raw, mask = gen.make_traffic(7, traffic,
            dict(azimuths=360, scan_period=0.1), "cpu")
        out = run_pipeline(raw[0].numpy(), mask[0].numpy())
        ok = np.isfinite(out["integrated"]).all() and len(out["features"]) == 3
        print(ok, [m for m in sys.modules if m.startswith("loam_tpu")])
    """)
    assert out.strip() == "True []"
