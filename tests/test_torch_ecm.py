"""The port's ECM package (``repro_torch.ecm``) against the reference's and
the paper's published numbers, and its H100 forecasts against values
computed by hand.

``model``, ``machines`` and ``kernels`` are plain Python: every
``PAPER_ANALYSES`` prediction equals the reference's field for field, and
the paper's numbers hold as tests/test_ecm_paper.py asserts them.
``attribution.attribute_phase`` equals the reference's on the same inputs
and the same machine figures. ``hopper`` prices on ``H100_SXM`` only:
data-sheet figures and the host link measured on the card.
"""

import dataclasses

import numpy as np
import pytest

from repro.ecm import attribution as r_attr
from repro.ecm import kernels as r_kernels
from repro.ecm import model as r_model
from repro_torch.ecm import attribution as attr
from repro_torch.ecm import hopper
from repro_torch.ecm import kernels as K
from repro_torch.ecm import machines as M
from repro_torch.ecm import model as ecm
from repro_torch.obs.residuals import ResidualLog


@pytest.mark.parametrize("key", sorted(K.PAPER_ANALYSES))
def test_paper_analyses_equal_reference(key):
    m, spec = K.PAPER_ANALYSES[key]
    rm, rspec = r_kernels.PAPER_ANALYSES[key]
    assert dataclasses.asdict(m) == dataclasses.asdict(rm)
    assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
    got, want = ecm.predict(m, spec), r_model.predict(rm, rspec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.performance_gups() == want.performance_gups()
    assert got.saturated_gups() == want.saturated_gups()
    assert got.shorthand() == want.shorthand()
    assert (ecm.scaling_curve(got, m.cores)
            == r_model.scaling_curve(want, rm.cores))


# The paper's published predictions (tests/test_ecm_paper.py's
# assertions): (machine, spec, t_ol, t_nol, t_ecm, GUP/s, n_S, P_sat).
_PAPER = {
    "hsw_naive": ("HSW", "naive", 1.0, 2.0, [2, 4, 9, 19.2],
                  [18.40, 9.20, 4.09, 1.92], 3, 4.0),
    "bdw_naive": ("BDW", "naive", None, None, [2, 4, 13, 26.4],
                  [16.80, 8.40, 2.58, 1.27], 4, None),
    "knc_naive": ("KNC", "naive", None, None, [2, 6, 26.8],
                  [8.40, 2.80, 0.63], 34, 21.3),
    "pwr8_naive": ("PWR8", "naive", 8.0, 0.0, [8, 8, 12, 22], None, 3,
                   None),
    "hsw_kahan_avx": ("HSW", "kahan_avx", 8.0, None, [8, 8, 9, 19.2],
                      None, None, 4.0),
    "hsw_kahan_fma": ("HSW", "kahan_fma", 8.0, None, [8, 8, 9, 19.2],
                      None, None, None),
    "hsw_kahan_fma_opt": ("HSW", "kahan_fma_opt", None, None,
                          [6.4, 6.4, 9, 19.2], None, None, None),
    "knc_kahan": ("KNC", "kahan", 4.0, None, [4, 8, 27.8], None, None,
                  21.3),
    "pwr8_kahan": ("PWR8", "kahan", 16.0, 0.0, [16, 16, 16, 22], None,
                   None, 9.3),
}


@pytest.mark.parametrize("case", sorted(_PAPER))
def test_paper_published_numbers(case):
    mname, kname, t_ol, t_nol, t_ecm, gups, n_s, p_sat = _PAPER[case]
    p = ecm.predict(*K.PAPER_ANALYSES[(mname, kname)])
    if t_ol is not None:
        assert p.t_ol == t_ol
    if t_nol is not None:
        assert p.t_nol == t_nol
    np.testing.assert_allclose(p.t_ecm, t_ecm, atol=0.3)
    if gups is not None:
        np.testing.assert_allclose(p.performance_gups(), gups, atol=0.01)
    if n_s is not None:
        assert p.n_saturation == n_s
    if p_sat is not None:
        np.testing.assert_allclose(p.saturated_gups(), p_sat, rtol=0.05)


def test_kahan_free_in_memory_and_scaling_curve():
    """The paper's headline on HSW / BDW: the Mem-level prediction of the
    AVX Kahan dot equals the naive one's; and Fig. 1's curve is linear,
    then flat at n_S."""
    for m in (M.HSW, M.BDW):
        naive = ecm.predict(m, K.naive_dot_spec(m))
        kah = ecm.predict(m, K.kahan_dot_avx_spec(m))
        assert kah.t_ecm[-1] == pytest.approx(naive.t_ecm[-1], abs=0.5)
        assert kah.t_ecm[0] >= 2 * naive.t_ecm[0]
    p = ecm.predict(M.HSW, K.naive_dot_spec(M.HSW))
    curve = ecm.scaling_curve(p, 7)
    assert curve[2] == pytest.approx(p.saturated_gups(), rel=0.05)
    assert curve[-1] == curve[3]


# ----------------------------------------------------------- attribution --

# one machine dict both modules can read (each reads its own key names)
_HW = {"peak_bf16_flops": 5e11, "vpu_f32_flops": 2e10, "peak_flops": 5e11,
       "f32_flops": 2e10, "hbm_bw": 4e10, "host_link_bw": 8e9}

_PHASES = [
    dict(phase="decode_step", calls=2947, flops=3.1e9, dot_flops=2.4e9,
         hbm_bytes=1.3e9, host_bytes=256.0, wall_s=0.06,
         machine_scale=1.7, dispatch_s=4e-6),
    dict(phase="prefill_chunk", calls=40, flops=4e11, dot_flops=3.9e11,
         hbm_bytes=2e9, host_bytes=1024.0, wall_s=0.2),
    dict(phase="swap_out", calls=3, flops=0.0, dot_flops=0.0,
         hbm_bytes=1e6, host_bytes=5e5, wall_s=1e-4, dispatch_s=1e-3),
    dict(phase="idle", calls=0, flops=0.0, dot_flops=0.0, hbm_bytes=0.0,
         host_bytes=0.0, wall_s=0.0),
]


@pytest.mark.parametrize("i", range(len(_PHASES)))
def test_attribute_phase_equals_reference(i):
    kw = dict(_PHASES[i])
    got = attr.attribute_phase(**kw, hw=_HW)
    want = r_attr.attribute_phase(**kw, hw=_HW)
    assert got.to_json() == want.to_json()
    assert got.counter_row() == want.counter_row()
    assert attr.render([got]) == r_attr.render([want])


def test_attribution_on_the_h100():
    """Default machine: H100_SXM. A phase of 1 GB of HBM bytes in 1 ms at
    scale 1 is 0.3 ms HBM-bound time; the rest is unattributed."""
    a = attr.attribute_phase("p", calls=10, flops=0.0, dot_flops=0.0,
                             hbm_bytes=1e9, host_bytes=0.0, wall_s=1e-3,
                             dispatch_s=1e-6)
    assert a.t_hbm_s == pytest.approx(1e9 / 3.35e12)
    assert a.t_dispatch_s == pytest.approx(1e-5)
    assert a.t_unattributed_s == pytest.approx(1e-3 - 1e9 / 3.35e12 - 1e-5)
    assert a.bound == "unattributed"
    assert set(a.fractions) == set(attr.CATEGORIES) | {"unattributed"}


# ---------------------------------------------------------------- hopper --

def test_h100_figures_are_the_cards():
    hw = M.H100_SXM
    assert hw["peak_flops"] == 989e12        # bf16 tensor cores
    assert hw["f32_flops"] == 67e12          # CUDA cores
    assert hw["hbm_bw"] == 3.35e12
    assert hw["host_link_bw"] == 49.704e9    # measured on the card
    assert set(M.PAPER_MACHINES) == {"HSW", "BDW", "KNC", "PWR8"}


def test_stream_kernels_by_hand():
    """Per update: max(flops / 67e12, bytes / 3.35e12)."""
    for spec in hopper.STREAM_KERNELS:
        p = hopper.predict(spec)
        t_c = spec.flops_per_update / 67e12
        t_d = spec.bytes_per_update / 3.35e12
        assert p.t_compute_s == pytest.approx(t_c)
        assert p.t_data_s == pytest.approx(t_d)
        assert p.updates_per_s == pytest.approx(1 / max(t_c, t_d))
        assert p.bound == ("data" if t_d >= t_c else "compute")
    assert hopper.ridge_flops_per_byte() == pytest.approx(67e12 / 3.35e12)
    # 2^24 pairs of the compensated dot: 128 MiB at 3.35 TB/s
    assert hopper.predicted_runtime_s(hopper.KAHAN_DOT, 1 << 24) == \
        pytest.approx(8 * (1 << 24) / 3.35e12)
    # the compensated accumulate pays only its carry stream: 20 / 12 B
    assert hopper.kahan_overhead(hopper.NAIVE_ACC, hopper.KAHAN_ACC) == \
        pytest.approx(20 / 12)


def test_b2f_first_residual():
    """B2f compensated / naive: predicted 1.0 (both HBM-bound), measured
    1.006 on the card (NVIDIA H100 80GB HBM3, 700.00 W)."""
    assert hopper.kahan_overhead() == pytest.approx(1.0)
    log = ResidualLog()
    rec = log.record("kahan_overhead/b2f", hopper.kahan_overhead(),
                     0.0571 / 0.0568, basis="wallclock", elems=1 << 24)
    assert rec.ratio == pytest.approx(1.00528, rel=1e-4)
    assert log.rows()[0][0] == "ecm_residual/kahan_overhead/b2f"


def test_serving_forecasts_by_hand():
    # quantized pools: the byte ratio, every format HBM-bound on the card
    assert hopper.predicted_decode_speedup("int8") == pytest.approx(
        2.0 / (1 + 4 / 64))
    assert hopper.predicted_decode_speedup("fp8", vec_len=512) == \
        pytest.approx(2.0 / (1 + 4 / 512))
    assert hopper.predicted_prefill_speedup(0.75) == pytest.approx(4.0)
    assert hopper.predicted_prefill_speedup(
        0.5, prompt_tokens=512, chunk_tokens=256) == 2.0
    assert hopper.expected_accepted_length(0.5, 3) == 1.875
    assert hopper.predicted_spec_speedup(0.5, 3) == 1.875
    assert hopper.predicted_spec_speedup(
        0.5, 3, draft_byte_ratio=0.25, context_len=100) == pytest.approx(
        1.875 / (102 / 100 + 1.0))
    assert hopper.predicted_session_prefill_reduction(
        0.5, promote_ratio=0.6, promoted_fraction=0.25) == \
        pytest.approx(1 / 0.75)
    with pytest.raises(ValueError):
        hopper.predicted_prefill_speedup(1.0)


def test_restore_gate_for_qwen_by_hand():
    """Full-width qwen1.5 (619 570 176 parameters, 98 304 bf16 pool bytes
    per token): re-prefill at 989 TFLOP/s against the restore at the
    measured 49.704 GB/s gives 0.6335, the crossover sitting at ~978 M
    parameters; with the dispatch term (4000 launches per 256-token
    chunk at 7.5 us each) re-prefill costs 117 us per token against a
    1.98 us restore, so ``promote="auto"`` promotes."""
    n, tb = 619_570_176, 98_304
    want = (2 * n / 989e12) / (tb / 49.704e9)
    got = hopper.predicted_restore_vs_reprefill(16, tb, 2 * n)
    assert got == pytest.approx(want) and got == pytest.approx(0.6335,
                                                               abs=1e-4)
    got = hopper.predicted_restore_vs_reprefill(
        16, tb, 2 * n, launches_per_chunk=4000, chunk_tokens=256)
    assert got == pytest.approx((4000 * 7.5e-6 / 256) / (tb / 49.704e9))
    assert hopper.restore_crossover_flops_per_token(tb) == pytest.approx(
        tb * 989e12 / 49.704e9)
