"""The frozen work model against values worked by hand."""

import pytest

from portbench import workmodel


def test_cas_transform_ops():
    assert workmodel.cas_transform_ops(64, 64) == 2 * 64 * 64 * 128 == 1_048_576
    assert workmodel.cas_transform_ops(128, 128) == 8_388_608


def test_ch_macro_64():
    # 4096 envs x 64^2 x 10 substeps, the full-size obs: 21 transforms an env.
    products, ew, nbytes = workmodel.ch_macro_work(4096, 64, 64, 10, ds=1)
    assert products == 21 * 1_048_576 * 4096 == 90_194_313_216
    assert ew == 21 * 4096 * 10 * 4096 == 3_523_215_360
    # field in and out, kappa, cas matrices, lam and lam2, obs and stats rows
    assert nbytes == 134_217_728 + 16_384 + 131_072 + 32_768 + 4096 * (4096 + 12)
    ms, what = workmodel.ch_macro_bound_ms(4096, 64, 64, 10, ds=1)
    assert what == "operations"
    assert ms == pytest.approx((90_194_313_216 / 989e12 + 3_523_215_360 / 67e12) * 1e3)
    assert ms == pytest.approx(0.143783, rel=1e-5)


def test_ch_macro_128():
    products, ew, nbytes = workmodel.ch_macro_work(1024, 128, 128, 10, ds=1)
    assert products == 21 * 8_388_608 * 1024 == 180_388_626_432
    assert ew == 3_523_215_360
    assert nbytes == 134_217_728 + 4096 + 524_288 + 131_072 + 1024 * (16384 + 12)
    ms, what = workmodel.ch_macro_bound_ms(1024, 128, 128, 10, ds=1)
    assert what == "operations"
    assert ms == pytest.approx(0.234981, rel=1e-5)


def test_pooled_obs_and_memory_bound():
    _, _, full = workmodel.ch_macro_work(4096, 64, 64, 10, ds=1)
    _, _, pooled = workmodel.ch_macro_work(4096, 64, 64, 10, ds=4)
    assert full - pooled == 4096 * (4096 - 256)
    # one substep of a tiny fleet is bound by its bytes
    assert workmodel.ch_macro_bound_ms(1, 8, 8, 1)[1] == "bytes"
