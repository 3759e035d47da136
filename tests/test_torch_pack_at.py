"""The v1 encoder's device pack, on the CPU: the packer's offsets entry and
the host's splice of the blocks it leaves.

`ops/pack.py::pack_blocks_at` (its plain version here) against the native
host packer (`native/bitio.py::pack_blocks_flat`) word for word, its rows
that are no plain block (k = 31, 32), its caps and its refusals; then
`codec/encoder.py::device_chunk`'s card path (`device_pack`) with
`pack_frames(..., card=...)` against `pack_frames` with every block left to
bitio, which the v2 and CPU paths run, escape blocks included, and the plan
check on planted count mismatches. The card
runs the same functions with the kernel (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from sela_tpu_torch.codec.encoder import (PLAN, device_chunk, frame_batches,
                                          pack_frames, serialize_frames)
from sela_tpu_torch.native import bitio
from sela_tpu_torch.ops.pack import pack_blocks_at
from sela_tpu_torch.ref import rice as ref_rice
from sela_tpu_torch.utils.metrics import Metrics

N_VALID = (0, 1, 31, 32, 2047, 2048)


def _rows(rng, kind: str, B: int = 12, N: int = 2048):
    """[B, N] int32 rows, k and n_valid for `kind`: laplace rows at their
    optimal k ("optimal"), at random k 0-30 ("random"), or full-scale int32
    rows at k = 30 ("full30"); n_valid runs through N_VALID."""
    nv = np.resize(np.array(N_VALID, np.int32), B)
    if kind == "full30":
        vals = rng.integers(-(1 << 31), 1 << 31, (B, N),
                            dtype=np.int64).astype(np.int32)
        vals[0, :4] = [-(1 << 31), (1 << 31) - 1, 0, -1]
        return vals, np.full(B, 30, np.int32), nv
    scale = 10.0 ** rng.uniform(0, 4, (B, 1))
    vals = np.round(rng.laplace(0, 1, (B, N)) * scale).astype(np.int32)
    if kind == "random":
        return vals, rng.integers(0, 31, B).astype(np.int32), nv
    ks = np.array([min(ref_rice.optimal_k(ref_rice.zigzag(vals[b, :nv[b]])),
                       30) for b in range(B)], np.int32)
    return vals, ks, nv


def _host(vals, ks, nv):
    """bitio's words and counts of the rows' blocks."""
    flat = vals[np.arange(vals.shape[1])[None, :] < nv[:, None]]
    return bitio.pack_blocks_flat(flat, np.concatenate(
        [[0], np.cumsum(nv.astype(np.int64))[:-1]]), nv, ks)


def _pack_at(vals, ks, nv, offs, caps, total, out=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (vals, ks, nv)]
    words, nwords = pack_blocks_at(*t, torch.from_numpy(offs),
                                   torch.from_numpy(caps), total, out=out)
    return words.numpy().view(np.uint32), nwords.numpy()


@pytest.mark.parametrize("kind", ["optimal", "random", "full30"])
def test_pack_at_matches_host_packer(kind):
    """At caps = the true counts and offs their cumsum, the flat buffer is
    bitio's concatenated words and nwords its counts."""
    rng = np.random.default_rng(len(kind))
    vals, ks, nv = _rows(rng, kind)
    words, wc = _host(vals, ks, nv)
    caps = wc.astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(wc)[:-1]]).astype(np.int64)
    got, nwords = _pack_at(vals, ks, nv, offs, caps, len(words))
    np.testing.assert_array_equal(nwords, wc)
    np.testing.assert_array_equal(got, words)


def test_pack_at_leaves_escape_and_partition_rows_to_the_host():
    """Rows at k = 31 and 32 read nwords -1 and leave their spans as `out`
    held them; the rows around them are packed as alone."""
    rng = np.random.default_rng(5)
    vals, ks, nv = _rows(rng, "optimal", B=8)
    ks[2], ks[5] = 31, 32
    plain = np.array([b not in (2, 5) for b in range(8)])
    _, wc = _host(vals[plain], ks[plain], nv[plain])
    caps = np.full(8, 40, np.int32)
    caps[plain] = wc
    offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    total = int(caps.sum())
    out = torch.full((total,), 0x5A5A5A5A, dtype=torch.int32)
    got, nwords = _pack_at(vals, ks, nv, offs, caps, total, out=out)
    assert nwords[2] == nwords[5] == -1
    np.testing.assert_array_equal(nwords[plain], wc)
    for b in (2, 5):
        assert (got[offs[b]:offs[b] + 40] == 0x5A5A5A5A).all()
    for b in np.flatnonzero(plain):
        want, _ = _host(vals[b:b + 1], ks[b:b + 1], nv[b:b + 1])
        np.testing.assert_array_equal(got[offs[b]:offs[b] + caps[b]], want)


def test_pack_at_writes_no_word_past_a_rows_cap():
    """A row whose true count exceeds its cap writes its first cap words,
    none past them, and reports its true count; a row with room to spare
    writes zeros after its words, up to its cap; a span past the buffer is
    clipped."""
    rng = np.random.default_rng(7)
    vals, ks, nv = _rows(rng, "random", B=4, N=256)
    nv[:] = 256
    _, wc = _host(vals, ks, nv)
    caps = np.array([wc[0] - 3, wc[1] + 5, wc[2], wc[3]], np.int32)
    offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    total = int(caps.sum()) - 2          # row 3's span runs past the end
    out = torch.full((total,), -1, dtype=torch.int32)
    got, nwords = _pack_at(vals, ks, nv, offs, caps, total, out=out)
    np.testing.assert_array_equal(nwords, wc)
    for b in range(4):
        want, _ = _host(vals[b:b + 1], ks[b:b + 1], nv[b:b + 1])
        span = got[offs[b]:min(offs[b] + caps[b], total)]
        n = min(len(want), len(span))
        np.testing.assert_array_equal(span[:n], want[:n])
        assert not span[n:].any(), b
    # row 0 stopped at its cap: row 1's first word is row 1's
    assert got[offs[1]] == _host(vals[1:2], ks[1:2], nv[1:2])[0][0]


def test_pack_at_refuses_bad_inputs():
    v = torch.zeros((4, 64), dtype=torch.int32)
    k = torch.zeros(4, dtype=torch.int32)
    offs = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        pack_blocks_at(v.long(), k, k, offs, k, 8)
    with pytest.raises(TypeError):       # offs must be int64
        pack_blocks_at(v, k, k, k, k, 8)
    with pytest.raises(ValueError):      # rows over 2,048 values
        pack_blocks_at(torch.zeros((4, 4096), dtype=torch.int32), k, k, offs,
                       k, 8)
    with pytest.raises(ValueError):
        pack_blocks_at(v, k[:3], k, offs, k, 8)
    with pytest.raises(ValueError):
        pack_blocks_at(torch.zeros((64, 4), dtype=torch.int32).t(), k, k,
                       offs, k, 8)
    with pytest.raises(ValueError):
        pack_blocks_at(v, k, k, offs, k, -1)
    with pytest.raises(ValueError):
        pack_blocks_at(v, k, k, offs, k, 8,
                       out=torch.zeros(9, dtype=torch.int32))


def _chunk(bits: int, rice_k_max, frames: int = 3, S: int = 2048):
    """device_chunk's outputs of a stereo clip on the CPU on the card's v1
    path (device_pack's plain version), as numpy: its plan, int32
    residues, word buffers and word counts."""
    rng = np.random.default_rng(bits)
    n = frames * S - 300
    t = np.arange(n)
    hi = (1 << (bits - 1)) - 1
    left = 0.5 * hi * np.sin(0.013 * t) + rng.normal(0, 0.002 * hi + 1, n)
    chans = [np.clip(np.round(x), -hi - 1, hi).astype(np.int32)
             for x in (left, 0.8 * left + rng.normal(0, 0.01 * hi + 1, n))]
    chans[0][::97] = -hi - 1            # full-scale spikes: wide residues
    x, nv = frame_batches(chans, S)
    out = device_chunk(torch.from_numpy(np.ascontiguousarray(x)),
                       torch.from_numpy(nv), True, False,
                       allow_ms=bits <= 24, rice_k_max=rice_k_max)
    return {k: v.numpy() for k, v in out.items()}, nv


def _card(out):
    """pack_frames' card argument from device_chunk's outputs."""
    rnw, cnw = out["nwords"].reshape(2, -1)
    return (out["res_words"], rnw), (out["coeff_words"], cnw)


def _spliced(out, nv, metrics=None):
    card = _card(out)
    need = (card[0][1] < 0).any()
    res = out["residues"] if need else None
    return pack_frames(out["plan"], res, nv, metrics, card), need


@pytest.mark.parametrize("bits,rice_k_max", [(16, None), (24, None),
                                             (32, None), (16, 0), (24, 7)],
                         ids=["16b", "24b", "32b", "16b-kmax0", "24b-kmax7"])
def test_device_pack_and_splice_match_pack_frames(bits, rice_k_max):
    """device_pack's words with the host's blocks spliced in
    (pack_frames(..., card=...)) are pack_frames' words and counts with
    every block packed by bitio, and serialize to the same bytes;
    rice_k_max 0 and 7 leave escape blocks of both kinds to the host."""
    out, nv = _chunk(bits, rice_k_max)
    plan = out["plan"]
    m = Metrics()
    got, fetched = _spliced(out, nv, m)
    want = pack_frames(plan, out["residues"], nv)
    for (gw, gc), (ww, wc) in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gw, ww)
    assert (serialize_frames(got, nv, 0, len(nv))
            == serialize_frames(want, nv, 0, len(nv)))
    blocks = 2 * plan.shape[0] * plan.shape[1]
    left = int((plan[:, :, PLAN.index("k_res")] == 31).sum()
               + (plan[:, :, PLAN.index("k_coeff")] == 31).sum())
    assert m.counters["pack_blocks_host"] == left
    assert m.counters["pack_blocks_device"] == blocks - left
    assert fetched == bool((plan[:, :, PLAN.index("k_res")] == 31).any())
    if rice_k_max == 0:
        assert left and fetched and "rice_pack" in m.stage_s
    if rice_k_max is None and bits <= 24:
        assert left == 0 and "rice_pack" not in m.stage_s


@pytest.mark.parametrize("where", ["card", "host"])
def test_splice_plan_check_raises_on_a_count_mismatch(where):
    """A block whose count is not the plan's raises, whether the card
    counted it or the host packed it (an escape block whose planned count
    was planted one short)."""
    out, nv = _chunk(16, None if where == "card" else 0)
    plan, card = out["plan"], _card(out)
    rnw = card[0][1]
    if where == "card":
        rnw[len(rnw) // 2] += 1
    else:
        row = int(np.flatnonzero(rnw < 0)[0])
        plan = plan.copy()
        plan.reshape(-1, plan.shape[2])[row, PLAN.index("nw_res")] -= 1
    with pytest.raises(RuntimeError, match="disagree on block sizes"):
        pack_frames(plan, out["residues"], nv, card=card)
