"""The port's tools (sela_tpu_torch/tools/) on the CPU, at small sizes.

- sweep_ratio: given the same rows, full-order reflections and counts, the
  port's `exact_bits_for_orders` (K1 -> K5 -> the render's Rice planning,
  here their plain versions) equals the JAX tool's, exactly; given the same
  Levinson errors, so do the COEFF_BIT_COST sweep's stream bits;
- check_regression: the cases of tests/test_regression_gate.py carried over
  to the port's bench line, and the refusal of lines from two devices;
- profile_stages: every stage `--only` at F = 4, and the driver mode;
- measure_scaling: the 2-rank merge has the single rank's sha256;
- roofline, sweep_kernels: the records' keys, and --out writes only there.
Times on the CPU say nothing of the card; only the records' shape and the
exact comparisons are checked.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu_torch.bench import make_corpus
from sela_tpu_torch.codec.encoder import frame_batches
from sela_tpu_torch.codec.pipeline import make_candidates
from sela_tpu_torch.ops.analysis import (autocorr_reference,
                                         levinson_full_reference)
from sela_tpu_torch.tools import (_common, check_regression, measure_scaling,
                                  profile_stages, roofline, sweep_kernels,
                                  sweep_ratio)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from sweep_ratio import exact_bits_for_orders as jax_exact_bits  # noqa: E402


@pytest.fixture(scope="module")
def corpus_rows():
    """1 s of the bench corpus: candidate rows, counts, K3's r, the full
    Levinson (plain versions on the CPU)."""
    left, right = make_corpus(1.0)
    x, n_valid = frame_batches([left, right])
    cand = make_candidates(torch.from_numpy(np.ascontiguousarray(x)))
    F, C2, S = cand.shape
    xb = cand.reshape(F * C2, S).contiguous()
    nv = torch.from_numpy(np.repeat(n_valid, C2).astype(np.int32))
    err, q_full = levinson_full_reference(autocorr_reference(xb))
    return dict(xb=xb, nv=nv, err=err, q_full=q_full, F=F, C2=C2)


def test_exact_bits_for_orders_matches_the_jax_tool(corpus_rows):
    xb, q_full, nv = (corpus_rows[k] for k in ("xb", "q_full", "nv"))
    got = sweep_ratio.exact_bits_for_orders(xb, q_full, nv)
    want = jax_exact_bits(jnp.asarray(xb.numpy()), jnp.asarray(q_full.numpy()),
                          jnp.asarray(nv.numpy()))
    assert got.shape == (xb.shape[0], 33)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_coeff_bit_cost_sweep_matches_the_jax_tool(corpus_rows):
    """The JAX tool's section 1 (inline in its main), on the same err and
    exact bits: the same stream bits for every COEFF_BIT_COST."""
    from sela_tpu.format import ORDER_QNOISE_PENALTY

    F, C2 = corpus_rows["F"], corpus_rows["C2"]
    bits_all = sweep_ratio.exact_bits_for_orders(
        corpus_rows["xb"], corpus_rows["q_full"], corpus_rows["nv"])
    err_np = corpus_rows["err"].numpy().astype(np.float64)
    nv_np = corpus_rows["nv"].numpy()

    def corpus_bits(order_choice):   # the JAX tool's, verbatim
        b_rows = np.take_along_axis(bits_all, order_choice[:, None], axis=1)[:, 0]
        b = b_rows.reshape(F, C2)
        return int(np.minimum(b[:, 0] + b[:, 1], b[:, 2] + b[:, 3]).sum())

    nvf = nv_np.astype(np.float64)[:, None]
    m = np.arange(33, dtype=np.float64)[None, :]
    adj = err_np + ORDER_QNOISE_PENALTY * m * err_np[:, :1]
    logerr = 0.5 * nvf * np.log2(np.maximum(adj, 1e-9))
    want = {str(cbc): corpus_bits(np.argmin(logerr + cbc * m, axis=1)
                                  .astype(np.int64)) for cbc in range(4, 11)}
    cost_np = 0.5 * nvf * np.log2(np.maximum(err_np, 1e-9)) + 7 * m
    want_plain = corpus_bits(np.argmin(cost_np, axis=1).astype(np.int64))
    got, got_plain = sweep_ratio.coeff_bit_cost_sweep(
        corpus_rows["err"].numpy(), nv_np, bits_all, F, C2,
        ORDER_QNOISE_PENALTY)
    assert got == want and got_plain == want_plain


def test_sweep_ratio_cpu_record():
    rec = sweep_ratio.sweep(1.0, 0, "cpu")
    assert rec["device"]["name"] == "cpu"
    assert set(rec["coeff_bit_cost_sweep_stream_bits"]) == {
        str(c) for c in range(4, 11)}
    assert rec["exact_order_stream_bits"] <= rec[
        "coeff_bit_cost_sweep_stream_bits"]["7"]
    assert 0 < rec["partitioned_v2_ratio"] < 1


# ------------------------------------------------------- check_regression --

def _line(pipe=20.0, ratio=0.54, walls=0.2, pack_ms=0.01, name="NVIDIA H100",
          full=True):
    """A line of `python -m sela_tpu_torch.bench`, cut to what the gate
    reads."""
    summary = {
        "e2e_cd": {"encode_s": walls, "decode_s": walls,
                   "compression_ratio": ratio, "pcm_mb": 31.75},
        "e2e_cd_v2": {"encode_s": walls, "compression_ratio": ratio * 0.999},
        "host_pack_mb_per_s": 900.0, "host_unpack_mb_per_s": 700.0,
        "device_pack": {"kernel_ms": pack_ms, "kernel_and_fetch_s": 1e-4,
                        "host_pack_s": 0.008},
        "device_pipeline_gbps": {"encode_gbps": pipe, "decode_gbps": pipe * 1.5},
        "link_mb_per_s": {"h2d_pinned": 41000, "d2h_pinned": 47000},
    }
    if full:
        summary["e2e_hires"] = {"encode_s": walls, "decode_s": walls,
                                "compression_ratio": 0.67}
        summary["batch64"] = {"encode_s": walls / 3, "decode_s": walls / 3,
                              "compression_ratio": 0.66,
                              "per_file_encode_s": walls * 2,
                              "per_file_decode_s": walls * 2}
    return {"metric": "e2e encode+decode GB/s", "value": 0.3 / walls,
            "unit": "GB/s", "device": {"name": name, "power_limit": "700.00 W"},
            "summary": summary, "iters": 3}


def _gate_no_regression(tmp_path):
    cr = check_regression
    assert cr.compare(_line(), _line()) == []
    assert cr.compare(_line(), _line(pipe=30.0, ratio=0.5, walls=0.1,
                                     pack_ms=0.005)) == []


def _gate_device_rate_regression(tmp_path):
    cr = check_regression
    fails = cr.compare(_line(pipe=20.0), _line(pipe=15.0))   # -25%
    assert any("device_pipeline.encode_gbps" in f for f in fails)
    assert cr.compare(_line(pipe=20.0), _line(pipe=19.0)) == []   # -5%
    fails = cr.compare(_line(pack_ms=0.010), _line(pack_ms=0.0125))
    assert any("device_pack.kernel_ms" in f for f in fails)
    assert cr.compare(_line(pack_ms=0.010), _line(pack_ms=0.0105)) == []


def _gate_walls_informational(tmp_path):
    notes = []
    fails = check_regression.compare(_line(walls=0.2), _line(walls=0.8),
                                     notes=notes)
    assert fails == []
    assert any("e2e_cd.encode_s" in n for n in notes)
    assert any("e2e_cd.aggregate_gbps" in n for n in notes)


def _gate_spread_of_one_tree_is_green(tmp_path):
    """The port's counterpart of the r03 -> r04 artifacts: two runs of one
    tree whose walls (0.158 and 0.428 s, PERF.md section 5) and link rates
    differ pass, with the deltas as notes."""
    slow = _line(walls=0.428)
    slow["summary"]["link_mb_per_s"] = {"h2d_pinned": 9700, "d2h_pinned": 6400}
    notes = []
    assert check_regression.compare(_line(walls=0.158), slow, notes=notes) == []
    assert any("link.h2d_pinned_mb_per_s" in n for n in notes)


def _gate_ratio_regression(tmp_path):
    cr = check_regression
    fails = cr.compare(_line(ratio=0.60), _line(ratio=0.65))   # +8.3%
    assert any("e2e_cd.compression_ratio" in f for f in fails)
    assert cr.compare(_line(ratio=0.60), _line(ratio=0.61)) == []   # +1.7%


def _gate_only_shared_metrics(tmp_path):
    cr = check_regression
    prev, cur = _line(full=False), _line()
    shared = set(cr.normalize(prev)) & set(cr.normalize(cur))
    assert not any(k.startswith(("batch64", "e2e_hires")) for k in shared)
    assert "device_pipeline.encode_gbps" in shared
    assert cr.compare(prev, cur) == []
    bad = _line(pipe=10.0)
    bad["summary"]["batch64"]["compression_ratio"] = 0.9
    fails = cr.compare(prev, bad)
    assert any("device_pipeline" in f for f in fails)
    assert not any("batch64" in f for f in fails)


def _gate_cli_exit_codes(tmp_path):
    prev, ok, bad = (tmp_path / f"{n}.json" for n in ("prev", "ok", "bad"))
    prev.write_text(json.dumps(_line()))
    ok.write_text(json.dumps(_line(pipe=22.0)))
    bad.write_text(json.dumps({"parsed": _line(pipe=10.0, walls=0.8)}))
    main = check_regression.main
    assert main(["--previous", str(prev), "--current", str(ok)]) == 0
    assert main(["--previous", str(prev), "--current", str(bad)]) == 1


def _gate_pinned_corpus_ratio(tmp_path):
    """The port's encoder on the pinned corpus (CPU) within the gate's +2%
    of tests/data/pinned_ratio.json, as the line's ratios are gated."""
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref.wav import WavData

    with open(os.path.join(REPO, "tests", "data", "pinned_ratio.json")) as f:
        pinned = json.load(f)
    w = WavData(44100, 16, list(make_corpus(pinned["seconds"],
                                            seed=pinned["seed"])))
    ratio = len(encode_wav(w, device="cpu")) / (w.n_samples * 2 * 2)
    prev, cur = _line(ratio=pinned["ratio"]), _line(ratio=ratio)
    assert check_regression.compare(prev, cur) == []


GATE_CASES = {f.__name__[len("_gate_"):]: f for f in (
    _gate_no_regression, _gate_device_rate_regression,
    _gate_walls_informational, _gate_spread_of_one_tree_is_green,
    _gate_ratio_regression, _gate_only_shared_metrics, _gate_cli_exit_codes,
    _gate_pinned_corpus_ratio)}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_check_regression(case, tmp_path):
    GATE_CASES[case](tmp_path)


@pytest.mark.parametrize("other", ["another card", "tpu record"])
def test_check_regression_refuses_another_device(other, tmp_path, capsys):
    prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
    prev.write_text(json.dumps(_line()))
    if other == "another card":
        cur.write_text(json.dumps(_line(name="NVIDIA H200")))
    else:   # a record of the JAX bench on the TPU (BENCH_r04.json)
        with open(os.path.join(REPO, "BENCH_r04.json")) as f:
            cur.write_text(f.read())
    capsys.readouterr()
    assert check_regression.main(["--previous", str(prev),
                                  "--current", str(cur)]) == 2
    assert json.loads(capsys.readouterr().out)["verdict"] == "refused"
    with pytest.raises(ValueError, match="different devices"):
        check_regression.compare(_line(), check_regression._load(str(cur)))


# --------------------------------------------------------- profile_stages --

_CORPUS: dict = {}


@pytest.fixture
def cached_corpus(monkeypatch):
    """The bench corpus made once for the tests of this module."""
    def corpus(seconds, *args, **kw):
        key = (seconds, args, tuple(sorted(kw.items())))
        if key not in _CORPUS:
            _CORPUS[key] = make_corpus(seconds, *args, **kw)
        return _CORPUS[key]

    monkeypatch.setattr(_common, "make_corpus", corpus)


@pytest.mark.parametrize("stage", profile_stages.STAGE_NAMES)
def test_profile_stages_only(stage, cached_corpus, capsys):
    assert profile_stages.main(["4", "--only", stage, "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["F"] == 4 and rec["device"]["name"] == "cpu"
    assert rec[stage]["ms"] > 0 and rec[stage]["pcm16_gbps"] > 0


def test_profile_stages_driver_mode():
    names = ["transpose_BN", "deq+ref2lpc"]
    rec = profile_stages.drive(4, cpu=True, names=names)
    assert list(rec["stages"]) == names
    assert all(rec["stages"][n]["ms"] > 0 for n in names)
    assert rec["device"]["name"] == "cpu" and rec["glue"] is None
    glue = profile_stages.glue({"encode_step(fus)": {"ms": 1.0},
                                "analyze_pallas": {"ms": 0.25},
                                "deq+ref2lpc": {"ms": 0.05},
                                "fir_rice_kernel": {"ms": 0.2}})
    assert glue["glue_ms"] == pytest.approx(0.5)
    assert glue["glue_share"] == pytest.approx(0.5)


# ----------------------------------------------- measure_scaling, roofline --

def test_measure_scaling_merge_has_the_single_rank_sha256():
    rec = measure_scaling.measure(2.0, [2], 256, cpu=True)
    run = rec["runs"]["2"]
    assert run["bit_exact_merge"] and len(run["wall_s"]) == 2
    assert len(rec["sha256"]) == 64 and rec["device"]["name"] == "cpu"


TINY = dict(tput=(4, 3, 40), fill=(8, 3, 40), lat=(1, 3, 40), iir=(4, 64),
            encode_frames=2, corpus_s=2.0)


@pytest.mark.parametrize("quick", [True, False])
def test_roofline_record_keys(quick):
    rec = roofline.measure("cpu", quick, TINY)
    keys = {"device", "int32", "model"} | (
        set() if quick else {"iir", "encode_kernels", "summary"})
    assert set(rec) == keys
    assert {"int32_tput_gops", "int32_latency_chain_gops", "imad_per_s",
            "imad_per_s_fill", "imad_per_clk_per_sm", "dependent_step_ns",
            "dependent_step_cycles", "sm_clock_mhz"} <= set(rec["int32"])
    assert rec["int32"]["sm_clock_mhz"] is None   # no card: no clock
    assert rec["model"]["iir_hbm_bound_pcm16_gbps"] == pytest.approx(837.5)
    if not quick:
        assert set(rec["iir"]) == {"iir", "iir_generic", "iir_one_row_ms",
                                   "shape"}
        assert rec["encode_kernels"]["shape"] == [8, 2048]


def test_tools_write_a_file_only_to_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "sub" / "r.json"
    out.parent.mkdir()
    assert roofline.main(["--cpu", "--quick", "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip()
    assert json.loads(line)["device"]["name"] == "cpu"
    assert out.read_text().strip() == line
    assert sorted(os.listdir(tmp_path)) == ["sub"]


def test_sweep_kernels_record(cached_corpus):
    rec = sweep_kernels.sweep(2, "cpu", corpus_s=2.0)
    assert rec["F"] == 2
    for name in ("fir_rice", "autocorr", "encode_step"):
        assert rec[name]["ms"] > 0
