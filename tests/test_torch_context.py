"""loam_tpu_torch's row-parallel normal equations (parallel/context.py,
ops/residuals.py) against loam_tpu's under row_sharding (CPU).

Outside a row_sharding context the normal equations must be the
single-card code bit for bit and make no torch.distributed call.  Inside
one, two ranks over gloo on loopback (tests/torch_dcn_worker.py) each
sum their half of the rows and one all_reduce adds the halves: both
ranks must hold the same bits, and the sums must match loam_tpu's
normal_equations under row_sharding on a (1, 2) mesh of virtual CPU
devices, and a float64 NumPy sum, to 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from loam_tpu.ops import residuals as JRes
from loam_tpu.parallel.context import row_sharding as j_row_sharding

from loam_tpu_torch.ops import residuals as TRes
from loam_tpu_torch.parallel import context as TC
from loam_tpu_torch.types import per_scenario

from torch_dcn_worker import count_collectives, run_ranks

torch.set_num_threads(1)

B, N = 3, 301          # an odd row count: the two blocks differ in size
REL = 1e-5             # of the largest entry


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(B, N, 6)).astype(np.float32)
    rhs = rng.normal(size=(B, N)).astype(np.float32)
    keep = rng.random((B, N)) > 0.3
    J = rng.normal(size=(B, N, 3, 6)).astype(np.float32)
    c = rng.normal(size=(B, N, 3, 2)).astype(np.float32)
    C = np.einsum("bnik,bnjk->bnij", c, c).astype(np.float32)
    b = rng.normal(size=(B, N, 3)).astype(np.float32)
    return dict(rows=rows, rhs=rhs, keep=keep, J=J, C=C, b=b)


def _float64(d):
    rows = d["rows"].astype(np.float64) * d["keep"][..., None]
    rhs = d["rhs"].astype(np.float64) * d["keep"]
    J, C, b = (d[k].astype(np.float64) for k in ("J", "C", "b"))
    return dict(
        ata=np.einsum("bni,bnj->bij", rows, rows),
        atb=np.einsum("bni,bn->bi", rows, rhs),
        acc_ata=np.einsum("znai,znab,znbj->zij", J, C, J),
        acc_atb=np.einsum("znai,zna->zi", J, b))


def _close(got, want, what):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= REL * scale, (what, err, scale)


def test_normal_equations_without_context_are_the_single_card_code():
    """No context: the same bits as the per-scenario products written out,
    the tensors returned untouched by the context, no distributed call."""
    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}

    def one(rows, rhs, keep):
        w = keep.to(rows.dtype)
        rows_m = rows * w[:, None]
        return rows_m.T @ rows_m, rows_m.T @ (rhs * w)

    def one_acc(J, C, b):
        CJ = torch.einsum("nab,nbj->naj", C, J)
        return (torch.einsum("nai,naj->ij", J, CJ),
                torch.einsum("nai,na->i", J, b))

    with count_collectives() as calls:
        got = TRes.normal_equations(d["rows"], d["rhs"], d["keep"])
        got_acc = TRes.normal_equations_accumulated(d["J"], d["C"], d["b"])
        assert TC.constrain_rows(d["rows"]) is d["rows"]
        assert TC.constrain_axis0(d["J"]) is d["J"]
        pair = TC.reduce_rows(d["rhs"], d["b"])
        assert pair[0] is d["rhs"] and pair[1] is d["b"]
        with TC.row_sharding(None):
            inside = TRes.normal_equations(d["rows"], d["rhs"], d["keep"])
    assert sum(calls.values()) == 0, calls
    want = per_scenario(one, d["rows"], d["rhs"], d["keep"])
    want_acc = per_scenario(one_acc, d["J"], d["C"], d["b"])
    for g, w in zip(got + got_acc + inside, want + want_acc + want):
        assert torch.equal(g, w)


def _jax_row_sharded(d):
    """loam_tpu's normal equations under row_sharding on a (1, 2) mesh of
    the virtual CPU devices, one scenario at a time."""
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    spec = NamedSharding(mesh, P("tp", None))

    @jax.jit
    def both(rows, rhs, keep, J, C, b):
        with j_row_sharding(spec):
            return (JRes.normal_equations(rows, rhs, keep)
                    + JRes.normal_equations_accumulated(J, C, b))

    outs = [both(*(jnp.asarray(d[k][i])
                   for k in ("rows", "rhs", "keep", "J", "C", "b")))
            for i in range(B)]
    return {k: np.stack([np.asarray(o[n]) for o in outs])
            for n, k in enumerate(("ata", "atb", "acc_ata", "acc_atb"))}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' row-split normal equations of _inputs(), over gloo."""
    d = _inputs()
    results, _ = run_ranks(str(tmp_path_factory.mktemp("ne")), d,
                           "normal_equations", timeout=120)
    return d, results


def test_row_split_ranks_hold_the_same_bits(two_ranks):
    _, (r0, r1) = two_ranks
    assert (int(r0["tp_rank"]), int(r1["tp_rank"])) == (0, 1)
    for k in ("ata", "atb", "acc_ata", "acc_atb"):
        np.testing.assert_array_equal(r0[k], r1[k])
    # one all_reduce a call, nothing else
    assert int(r0["all_reduce"]) == int(r0["calls"]) == 2


def test_row_split_sums_match_loam_tpu_and_float64(two_ranks):
    d, (r0, _) = two_ranks
    jax_sums = _jax_row_sharded(d)
    exact = _float64(d)
    for k in ("ata", "atb", "acc_ata", "acc_atb"):
        _close(r0[k], exact[k], ("port", k))
        _close(jax_sums[k], exact[k], ("loam_tpu", k))
        _close(r0[k], np.asarray(jax_sums[k], np.float64), ("both", k))
    # the split moved the sums off the whole-row sums by rounding only
    whole = TRes.normal_equations(*(torch.from_numpy(d[k])
                                    for k in ("rows", "rhs", "keep")))
    _close(r0["ata"], whole[0].double().numpy(), "whole")
