"""counts.py: the peaks and the operations and bytes each kernel family
needs."""
import types

import numpy as np
import pytest

from perfbench import counts


def test_peaks_are_the_data_sheets():
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert counts.FP32_OPS_PER_S == 33.5e12


@pytest.mark.parametrize("nbytes,ops,want", [
    (3.35e12, 0, 1.0), (0, 33.5e12, 1.0), (3.35e12, 67e12, 2.0),
    (6.7e12, 33.5e12, 2.0)])
def test_bound_is_the_larger_term(nbytes, ops, want):
    assert counts.bound_s(nbytes, ops) == pytest.approx(want)


def test_mindist_need_counts_codes_once_and_3w_a_pair():
    assert counts.mindist_need(64, 2000, 16) == (2000 * 16,
                                                 64 * 2000 * 3 * 16)


def test_euclid_need_counts_rows_and_queries_once():
    nb, ops = counts.euclid_need(pairs=5000, distinct_rows=300, nq=64, L=256)
    assert nb == (300 + 64) * 256 * 4
    assert ops == 5000 * (3 * 256 - 1)


def test_scanned_rows_is_capped_by_a_short_last_leaf():
    assert counts.scanned_rows(4195, 2000, 8388608) == 8388608
    assert counts.scanned_rows(16, 2000, 8388608) == 32000


def test_search_bounds_from_a_batchs_accounting():
    st = types.SimpleNamespace(
        leaves_scanned=10, candidates=700, buffer_rows=100,
        candidates_per_query=np.array([300, 400]))
    mb, eb = counts.search_bounds(st, nq=2, L=256, w=16, leaf_size=100,
                                  sorted_rows=10_000)
    assert mb == counts.bound_s(*counts.mindist_need(2, 1000, 16))
    assert eb == counts.bound_s(*counts.euclid_need(700, 800, 2, 256))
