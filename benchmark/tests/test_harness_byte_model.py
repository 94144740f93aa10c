"""The byte model the roofline share divides by."""

import numpy as np
import pytest

from harness import byte_model as bm


def test_dense_pass_bytes_fold4_billion():
    n = 1_020_017_472
    nbytes = bm.dense_pass_bytes(n, 8, batch=1, k_fetch=256)
    # every folded word (32 B a row) and popcount (2 B a row) once, and the
    # candidates: about 34.7 GB, 10.35 ms at 3.35 TB/s
    assert nbytes == bm.padded_rows(n) * 34 + 256 * 12
    assert 34.6e9 < nbytes < 34.8e9
    assert bm.least_seconds(nbytes) == pytest.approx(nbytes / 3.35e12)


def test_bitplane_pass_bytes_reads_only_the_query_planes():
    n = 113_335_291
    one = bm.bitplane_pass_bytes(n, 40, batch=1, k_fetch=128)
    assert one == 40 * (bm.padded_rows(n) // 32) * 4 + bm.padded_rows(n) * 2 + 128 * 12
    # the union of a batch's bits, not the sum
    assert bm.bitplane_pass_bytes(n, 60, 2, 128) < 2 * one


def test_expected_union_bits():
    bits = np.zeros((4, 16), np.uint8)
    bits[0, :4] = bits[1, 2:6] = bits[2, 8:12] = bits[3, 12:16] = 1
    assert bm.expected_union_bits(bits, 1, seed=0) == 4.0
    assert bm.expected_union_bits(bits, 4, seed=0) == 14.0
    two = bm.expected_union_bits(bits, 2, seed=0)
    assert 7.0 <= two <= 8.0
    assert bm.expected_union_bits(bits, 1.5, seed=0) == pytest.approx(
        4.0 + 0.5 * (two - 4.0), rel=0.05)


def test_padded_rows():
    assert bm.padded_rows(1) == 256 and bm.padded_rows(256) == 256
    assert bm.padded_rows(257) == 512
