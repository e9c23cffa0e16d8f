"""The port's own copy of pimsim (``repro_torch.pimsim``) against
``repro.pimsim``, on the CPU.

Both are pure Python over the same constants, so every function must give
the JAX package's floats exactly (``==``, no tolerance) over a grid of
models x devices x designs x context lengths x batches x KV splits; the
calibration report must be equal. Then every contract of
``tests/test_pimsim.py`` re-established on the port's copy, with that file's
tolerances: the paper's anchors (35.7 s, 3.53 s, 90.2 %, 10.1x, 18.6x), the
held-out averages (11.42x, 4.25x, 1.12x), the HBCEM maxima, the LBIM
orderings, the bandwidth hierarchy, the KV cross mapping, low batch and the
CU overhead.
"""
import dataclasses
import io
import statistics
from contextlib import redirect_stdout

import pytest

import repro.pimsim as J
import repro.pimsim.calibrate as jcal
import repro.pimsim.overhead as jover
import repro_torch.pimsim as T
import repro_torch.pimsim.calibrate as tcal
import repro_torch.pimsim.overhead as tover

COMBOS = [(128, 128), (128, 2048), (2048, 128), (2048, 2048)]
CONTEXTS = (1, 37, 128, 2048, 32768)
BATCHES = (1, 3, 16)
SPLITS = (1, 2, 4, 64)


def close(ours, paper, tol):
    assert abs(ours / paper - 1) < tol, f"{ours:.3f} vs paper {paper} (tol {tol})"


# ---- the copy equals the original, float for float ---------------------------


def test_constants_equal():
    for table_j, table_t in ((J.MODELS, T.MODELS), (J.DEVICES, T.DEVICES),
                             (J.DESIGNS, T.DESIGNS)):
        assert list(table_j) == list(table_t)
        for name in table_j:
            assert dataclasses.asdict(table_t[name]) == dataclasses.asdict(table_j[name])
    import repro.pimsim.latency as jl
    import repro_torch.pimsim.latency as tl
    for k in ("GPU_WEIGHT_BYTES", "GPU_KV_BYTES", "PIM_BYTES", "AUX_REF_WIDTH",
              "AUX_BATCH_POWER", "SPLIT_MERGE_OVERHEAD_S"):
        assert getattr(tl, k) == getattr(jl, k)
    assert tover.AREA_BREAKDOWN == jover.AREA_BREAKDOWN
    assert tover.POWER_BREAKDOWN == jover.POWER_BREAKDOWN
    assert dataclasses.asdict(tover.cu_overhead()) == dataclasses.asdict(jover.cu_overhead())
    assert list(tover.cu_overhead().rows()) == list(jover.cu_overhead().rows())


def test_exports_equal():
    names = [n for n in dir(J) if not n.startswith("_") and n not in
             ("device", "latency", "llm", "pim", "scheduler")]
    assert names == [n for n in dir(T) if not n.startswith("_") and n not in
                     ("device", "latency", "llm", "pim", "scheduler")]


@pytest.mark.parametrize("mname", list(J.MODELS))
def test_llm_accounting_equal(mname):
    mj, mt = J.MODELS[mname], T.MODELS[mname]
    assert (mt.linear_params, mt.total_params, mt.decode_io_bytes()) == \
        (mj.linear_params, mj.total_params, mj.decode_io_bytes())
    for w in (1, 2):
        assert mt.decode_linear_bytes(w) == mj.decode_linear_bytes(w)
    for ctx in CONTEXTS:
        assert mt.decode_kv_bytes(ctx) == mj.decode_kv_bytes(ctx)
        assert mt.decode_kv_bytes(ctx, 2) == mj.decode_kv_bytes(ctx, 2)
        assert mt.decode_macs(ctx) == mj.decode_macs(ctx)
        assert mt.prefill_flops(ctx) == mj.prefill_flops(ctx)
        assert mt.prefill_bytes(ctx) == mj.prefill_bytes(ctx)


@pytest.mark.parametrize("dname", list(J.DEVICES))
def test_design_rates_equal(dname):
    dj, dt = J.DEVICES[dname], T.DEVICES[dname]
    assert (dt.total_banks, dt.ext_bw, dt.flops) == (dj.total_banks, dj.ext_bw, dj.flops)
    for name, pj in J.DESIGNS.items():
        pt = T.DESIGNS[name]
        assert pt.internal_bw(dt) == pj.internal_bw(dj)
        assert pt.cu_macs_per_s(dt) == pj.cu_macs_per_s(dj)
        for lbim in (False, True):
            assert pt.gemv_bytes_per_s(dt, lbim) == pj.gemv_bytes_per_s(dj, lbim)
            assert pt.attn_gemv_bytes_per_s(dt, lbim) == pj.attn_gemv_bytes_per_s(dj, lbim)


@pytest.mark.parametrize("dname", list(J.DEVICES))
@pytest.mark.parametrize("mname", list(J.MODELS))
def test_stage_times_equal_over_the_grid(mname, dname):
    """aux, prefill, GPU and PIM decode steps and verify at every context,
    batch, design, LBIM flag and split count of the grid."""
    mj, mt = J.MODELS[mname], T.MODELS[mname]
    dj, dt = J.DEVICES[dname], T.DEVICES[dname]
    for b in BATCHES:
        assert T.latency.aux_time(dt, mt, b) == J.latency.aux_time(dj, mj, b)
        for ctx in CONTEXTS:
            assert T.gpu_prefill_time(mt, ctx, dt, b) == J.gpu_prefill_time(mj, ctx, dj, b)
            assert (T.gpu_prefill_time(mt, ctx, dt, b, bw_fraction=0.5)
                    == J.gpu_prefill_time(mj, ctx, dj, b, bw_fraction=0.5))
            assert (T.gpu_decode_step_time(mt, ctx, dt, b)
                    == J.gpu_decode_step_time(mj, ctx, dj, b))
            for n in (1, 4):
                assert (T.verify_step_time(mt, n, ctx, dt, b)
                        == J.verify_step_time(mj, n, ctx, dj, b))
            for name, pj in J.DESIGNS.items():
                pt = T.DESIGNS[name]
                for lbim in (False, True):
                    for s in SPLITS:
                        assert (T.pim_decode_step_time(mt, ctx, dt, pt, b, lbim, s)
                                == J.pim_decode_step_time(mj, ctx, dj, pj, b, lbim, s))


@pytest.mark.parametrize("dname", list(J.DEVICES))
@pytest.mark.parametrize("mname", list(J.MODELS))
def test_end_to_end_models_equal(mname, dname):
    """gpu_only / hbcem / lbim end to end, the LBIM trace and the blocked
    trace, over (Lin, Lout), batches and designs."""
    mj, mt = J.MODELS[mname], T.MODELS[mname]
    dj, dt = J.DEVICES[dname], T.DEVICES[dname]
    for lin, lout in ((128, 32), (2048, 8), (37, 129)):
        for b in (1, 4):
            g = (T.gpu_only_e2e(mt, lin, lout, dt, b), J.gpu_only_e2e(mj, lin, lout, dj, b))
            assert dataclasses.asdict(g[0]) == dataclasses.asdict(g[1])
            assert (g[0].total, g[0].ttft_fraction) == (g[1].total, g[1].ttft_fraction)
            for name in ("cd-pim", "attacc-lpddr", "cd-pim-fixed-kv", "conventional-pim"):
                pj, pt = J.DESIGNS[name], T.DESIGNS[name]
                assert (dataclasses.asdict(T.hbcem_e2e(mt, lin, lout, dt, pt, b))
                        == dataclasses.asdict(J.hbcem_e2e(mj, lin, lout, dj, pj, b)))
                trj, trt = J.Trace(), T.Trace()
                assert (dataclasses.asdict(T.lbim_e2e(mt, lin, lout, dt, pt, b, trace=trt))
                        == dataclasses.asdict(J.lbim_e2e(mj, lin, lout, dj, pj, b,
                                                         trace=trj)))
                assert trt.events == trj.events
                assert (T.blocked_trace(mt, lin, lout, dt, pt, b).events
                        == J.blocked_trace(mj, lin, lout, dj, pj, b).events)


def test_clock_to_time_equal():
    tl = [(1, 0.5), (3, 0.75), (4, 1.25), (9, 2.0)]
    for timeline in ([], tl):
        for clock in range(-1, 12):
            assert T.clock_to_time(timeline, clock) == J.clock_to_time(timeline, clock)


def test_replay_report_json_equal():
    kw = dict(total_s=1.5, decode_busy_s=1.0, prefill_busy_s=0.75,
              overlap_saved_s=1e-17, spec_proposed=4, spec_accepted=3)
    rj, rt = J.ReplayReport(**kw), T.ReplayReport(**kw)
    assert rt.to_json() == rj.to_json()
    assert rt.to_json()["overlap_saved_s"] == 0.0       # exact-zero export of ~1e-17
    assert (rt.serialized_s, rt.acceptance_rate) == (rj.serialized_s, rj.acceptance_rate)


def test_calibration_report_equal(monkeypatch):
    rep = tcal.report()
    assert rep == jcal.report()
    monkeypatch.setattr(tcal, "report", lambda: rep)   # main() formats the same report
    out = io.StringIO()
    with redirect_stdout(out):
        tcal.main()
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 + len(rep)
    assert [ln.split()[0] for ln in lines[1:]] == list(rep)


# ---- tests/test_pimsim.py's contracts, on the port's copy --------------------
# anchors (fitted; must stay within 10%)


def test_anchor_gpu_e2e_35_7s():
    close(T.gpu_only_e2e(T.LLAMA_1B, 128, 2048, T.JETSON).total, 35.7, 0.10)


def test_anchor_pim_e2e_3_53s():
    close(T.hbcem_e2e(T.LLAMA_1B, 128, 2048, T.JETSON, T.CDPIM).total, 3.53, 0.10)


def test_anchor_decode_reduction_90_2pct():
    g = T.gpu_only_e2e(T.LLAMA_1B, 128, 2048, T.JETSON)
    h = T.hbcem_e2e(T.LLAMA_1B, 128, 2048, T.JETSON, T.CDPIM)
    close(1 - h.decode_s / g.decode_s, 0.902, 0.03)


def test_anchor_jetson_speedup_10_1x():
    g = T.gpu_only_e2e(T.LLAMA_1B, 128, 2048, T.JETSON).total
    h = T.hbcem_e2e(T.LLAMA_1B, 128, 2048, T.JETSON, T.CDPIM).total
    close(g / h, 10.1, 0.10)


def test_anchor_iphone_speedup_18_6x():
    g = T.gpu_only_e2e(T.LLAMA_1B, 128, 2048, T.IPHONE).total
    h = T.hbcem_e2e(T.LLAMA_1B, 128, 2048, T.IPHONE, T.CDPIM).total
    close(g / h, 18.6, 0.05)


# held-out validations


def test_average_speedup_vs_gpu_11_42x():
    sps = [T.gpu_only_e2e(m, li, lo, d).total / T.hbcem_e2e(m, li, lo, d, T.CDPIM).total
           for d in (T.JETSON, T.IPHONE) for m in T.MODELS.values() for li, lo in COMBOS]
    close(statistics.mean(sps), 11.42, 0.15)


def test_average_speedup_vs_attacc_4_25x():
    sps = [T.hbcem_e2e(m, li, lo, d, T.ATTACC).total / T.hbcem_e2e(m, li, lo, d, T.CDPIM).total
           for d in (T.JETSON, T.IPHONE) for m in T.MODELS.values() for li, lo in COMBOS]
    close(statistics.mean(sps), 4.25, 0.15)


@pytest.mark.parametrize("model,paper_max", [
    (T.LLAMA_1B, 10.51), (T.LLAMA_7B, 13.74), (T.LLAMA_13B, 14.6)])
def test_jetson_hbcem_maxima(model, paper_max):
    sps = [T.gpu_only_e2e(model, li, lo, T.JETSON).total
           / T.hbcem_e2e(model, li, lo, T.JETSON, T.CDPIM).total for li, lo in COMBOS]
    close(max(sps), paper_max, 0.15)


def _lbim_gain(m, d, lo):
    return (T.hbcem_e2e(m, 2048, lo, d, T.CDPIM, batch=4).total
            / T.lbim_e2e(m, 2048, lo, d, T.CDPIM, batch=4).total)


def test_lbim_average_1_12x():
    sps = [_lbim_gain(m, d, lo) for d in (T.JETSON, T.IPHONE) for m in T.MODELS.values()
           for lo in (2, 8, 32, 128)]
    close(statistics.mean(sps), 1.12, 0.10)


def test_lbim_never_slower_than_hbcem():
    for d in (T.JETSON, T.IPHONE):
        for m in T.MODELS.values():
            for lo in (2, 8, 32, 128):
                assert _lbim_gain(m, d, lo) >= 0.999, (d.name, m.name, lo)


def test_lbim_iphone_below_jetson():
    """Paper: iPhone gains smaller than Jetson for LLaMA-1B (1.23 vs 1.41)."""
    j = [_lbim_gain(T.LLAMA_1B, T.JETSON, lo) for lo in (32, 128)]
    i = [_lbim_gain(T.LLAMA_1B, T.IPHONE, lo) for lo in (32, 128)]
    assert max(i) < max(j)


# design-space structure


def test_cdpim_bandwidth_hierarchy():
    """CD-PIM 4x conventional; FOLD/Pipe/DH 2x; AttAcc below conventional."""
    base = T.CONVENTIONAL.gemv_bytes_per_s(T.JETSON)
    assert abs(T.CDPIM.gemv_bytes_per_s(T.JETSON) / base - 4.0) < 1e-6
    for d in (T.FOLD_PIM, T.PIPE_PIM, T.DH_PIM):
        assert abs(d.gemv_bytes_per_s(T.JETSON) / base - 2.0) < 1e-6
    assert T.ATTACC.gemv_bytes_per_s(T.JETSON) < base


def test_internal_bandwidth_exceeds_external():
    assert T.CDPIM.gemv_bytes_per_s(T.JETSON) > 10 * T.JETSON.ext_bw


def test_kv_cross_mapping_helps():
    """§III-C: fixed mapping degrades attention GEMVs by the Pbank factor."""
    for m in T.MODELS.values():
        cross = T.hbcem_e2e(m, 128, 2048, T.JETSON, T.CDPIM).total
        fixed = T.hbcem_e2e(m, 128, 2048, T.JETSON, T.CDPIM_FIXED_MAPPING).total
        assert fixed > cross
    assert T.CDPIM_FIXED_MAPPING.attn_gemv_bytes_per_s(T.JETSON) * 4 == \
        pytest.approx(T.CDPIM.attn_gemv_bytes_per_s(T.JETSON))


def test_pim_favors_low_batch():
    """PIM speedup shrinks as batch grows (no weight reuse across GEMVs)."""
    s1 = T.gpu_only_e2e(T.LLAMA_1B, 128, 256, T.JETSON, batch=1).total / \
        T.hbcem_e2e(T.LLAMA_1B, 128, 256, T.JETSON, T.CDPIM, batch=1).total
    s16 = T.gpu_only_e2e(T.LLAMA_1B, 128, 256, T.JETSON, batch=16).total / \
        T.hbcem_e2e(T.LLAMA_1B, 128, 256, T.JETSON, T.CDPIM, batch=16).total
    assert s16 < s1


def test_overhead_matches_paper():
    rep = tover.cu_overhead()
    assert rep.pu_area_um2 == 14941.0
    assert rep.total_power_mw == pytest.approx(144.0)
    assert 0.005 < rep.die_area_fraction < 0.012  # ~0.8%
