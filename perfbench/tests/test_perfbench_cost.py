"""The roofline arithmetic against hand-counted cases."""

import torch

from pbench import cost


def test_windowed_knn_hand_count():
    # one scenario, 5 live queries in blocks of 4, 10 live references in
    # tiles of 4; block 0 scans tiles [0, 2) = refs 0-7, block 1 tiles
    # [1, 3) = refs 4-11, cut at 10 live: 4-9
    n_q, n_ref = torch.tensor([5]), torch.tensor([10])
    t_lo, t_hi = torch.tensor([[0, 1]]), torch.tensor([[2, 3]])
    ops, n_bytes = cost.windowed_knn(n_q, n_ref, 3, t_lo, t_hi, tq=4, tm=4)
    pairs = 4 * 8 + 1 * 6
    assert ops == 9 * pairs
    assert n_bytes == 12 * (5 + 10) + 8 * 3 * 5 + 8 * 2


def test_candidate_select_hand_count():
    valid = torch.tensor([[True, False, True], [True, True, True]])
    ops, n_bytes = cost.candidate_select(valid, 2)
    assert ops == 9 * 5
    assert n_bytes == 2 * 3 * 13 + 2 * 12 + 2 * 2 * 16


def test_least_seconds():
    card = "NVIDIA H100 80GB HBM3"
    assert cost.least_seconds(67e12, 0, card) == 1.0
    assert cost.least_seconds(0, 3.35e12, card) == 1.0
    assert cost.least_seconds(67e12, 6.7e12, card) == 2.0
    assert cost.least_seconds(1, 1, "another card") is None
