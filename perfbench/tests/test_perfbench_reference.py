"""The frozen reference against a direct brute force at tiny sizes, and
its controls against it."""
import pytest
import torch

from perfbench import reference, summaries, walks


def _walks(seed, n, L=64):
    return walks.make_walks(walks.generator("cpu", seed, 1), n, L)


def _brute(rows, q, k):
    d = ((rows[None].double() - q[:, None].double()) ** 2).sum(-1)
    return torch.sort(d, dim=1, stable=True)


@pytest.mark.parametrize("lo,hi", [(0, 3000), (700, 2900), (0, 10)])
def test_knn_equals_a_float64_brute_force(lo, hi, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 1024)
    rows = _walks(3, 3000)
    q = walks.query_batch(walks.generator("cpu", 3, 2), rows, 16)
    d, i = reference.knn(rows, lo, hi, q, 10)
    bd, bi = _brute(rows[lo:hi], q, 10)
    assert torch.equal(i, bi[:, :10] + lo)
    assert reference.rel_gap(d, bd[:, :10].float()) < 1e-6


def test_tf32_control_is_a_precision_below():
    x = torch.randn(4096)
    t = reference.tf32(x)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0 ** -11
    rows = _walks(4, 3000)
    q = walks.query_batch(walks.generator("cpu", 4, 2), rows, 16)
    d, _ = reference.knn(rows, 0, 3000, q, 10)
    c, _ = reference.knn(rows, 0, 3000, q, 10, precision="tf32")
    assert reference.rel_gap(c, d) > 1e-4


def test_rel_gap():
    b = torch.tensor([1.0, 2.0, float("inf")])
    assert reference.rel_gap(torch.tensor([1.0, 2.2, 5.0]), b) \
        == pytest.approx(0.1)
    assert reference.rel_gap(torch.tensor([1.0, float("inf"), 1.0]), b) \
        == float("inf")


def test_paa_sums_in_index_order():
    x = torch.randn(5, 64, dtype=torch.float64)
    p = summaries.paa(x.float(), 8)
    want = x.reshape(5, 8, 8).mean(-1)
    assert torch.allclose(p.double(), want, atol=1e-6)


def test_sax_codes_and_keys_follow_the_paper():
    bps = summaries.breakpoints(2)
    assert torch.allclose(bps, torch.tensor([-0.6745, 0.0, 0.6745]),
                          atol=1e-4)
    p = torch.tensor([[-1.0, 0.1, 0.7, -0.1]])
    codes = summaries.sax_encode(p, 2)
    assert codes.tolist() == [[0, 2, 3, 1]]
    # MSB plane first: bits 1 of (0,2,3,1) = 0,1,1,0; bits 0 = 0,0,1,1
    key = summaries.interleave_codes(codes, 4, 2)
    assert key.tolist() == [[int("01100011", 2) << 24]]


def test_lexsort_is_stable_and_lexicographic():
    keys = torch.tensor([[2, 1], [1, 5], [2, 0], [1, 5], [0, 9]])
    assert summaries.lexsort_keys(keys).tolist() == [4, 1, 3, 2, 0]


def test_build_reference_and_its_control():
    rows = _walks(5, 4000, L=256)
    ref = reference.build_reference(rows, 16, 8)
    paas, codes, keys, order = ref
    cols = (order, paas[order], codes[order], keys[order], rows[order])
    assert reference.build_mismatches(rows, ref, cols) == 0
    bad = (order.flip(0), paas[order], codes[order], keys[order],
           rows[order])
    assert reference.build_mismatches(rows, ref, bad) > 0
    ctl = reference.build_reference(rows, 16, 8, dtype=torch.bfloat16)
    c = (ctl[3], ctl[0][ctl[3]], ctl[1][ctl[3]], ctl[2][ctl[3]],
         rows[ctl[3]])
    assert reference.build_mismatches(rows, ref, c) > 1000
