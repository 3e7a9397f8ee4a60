"""The plain reference of scanning: the patterns `get` must report.

Upstream audiowmark's get (src/syncfinder.cc, src/wmget.cc,
src/convcode.cc), written from the upstream semantics in plain torch:

* sync search: a dB spectrogram at hops of 256 samples; for every start,
  per sync bit the summed up-band and down-band levels of its sync frames
  give 1 - u/d or d/u - 1, signed by the bit's expected value; the mean
  over the bits times 1 / (2.9 min(water_delta, 0.08)) is the raw quality;
  a local mean over +-[4, 20] hops is subtracted; local maxima (a chosen
  peak skips its right neighbour), minus those with an opposite-sign
  neighbour three times larger within 23 hops, the best of them by
  |q - mean| (all above 0.75 * threshold, at least n_best); each refined
  over +-256 samples in steps of 8; then the same choice at the
  threshold.  Quality |q - mean|, block A where q > mean;
* extraction: per block frame and channel the dB bands minus the mean of
  the neighbouring frames' (reflected at the block edges), summed over the
  channels; per coded bit the sum over its mix entries of up - down; the
  inverse interleave; soft bits 0.5 (v / mean|v| + 1);
* decode: the order-15 code's Viterbi over 32768 states, branch metric the
  squared distance to the state's coded bits, ties to the low
  predecessor, traced back from state 0; the error is the final metric at
  state 0 over the coded length;
* patterns: every block candidate; A + B joined where a B lies a block
  after an A within half a frame; the "all" chain of alternating blocks at
  block spacing with the best summed quality; for streams shorter than
  3.1 blocks the clip windows (the start and the end, ~2 blocks zero-
  padded) searched for a two-block span with silence skipped.

`reference_patterns` returns a superset: every selection keeps `extra`
candidates beyond the ones upstream keeps, and every A-B pair at the right
distance is joined, so that a candidate the program keeps where two
qualities tie to rounding still has its counterpart here.  The selection
steps on the host are plain numpy, as upstream's are plain C++.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import keyed
from .dsp import db_bands
from .keyed import Geom, Layout
from .prec import Prec

SHIFTS = 4                      # hops per frame (frame_size / step)
# refined qualities this close to a candidate's best are ties to float32
# rounding (the program's qualities lie up to ~5e-4 from float64's)
TIE = 2e-3


@dataclass
class RefPattern:
    kind: str                   # "block", "clip" or "all"
    block_type: str             # "a", "b" or "ab"
    index: int                  # sample index (block), window start (clip)
    quality: float
    error: float = float("nan")
    bits: Optional[np.ndarray] = None
    soft: Optional[np.ndarray] = field(default=None, repr=False)
    core: bool = False          # kept by upstream's own selection


# ---- sync search ---------------------------------------------------------

def _norm(g: Geom) -> float:
    return 1.0 / (min(g.water_delta, 0.080) * 2.9)


def _bit_quality(u, d, cnt, g: Geom):
    """u, d, cnt: (..., sync_bits) -> quality (...)."""
    expect = (torch.arange(g.sync_bits, device=u.device) & 1) > 0
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    safe_u = torch.where(u == 0, torch.ones_like(u), u)
    raw = torch.where((u == 0) | (d == 0), torch.zeros_like(u),
                      torch.where(u < d, 1.0 - u / safe_d, d / safe_u - 1.0))
    q = torch.where(expect, raw, -raw)
    if cnt is None:
        return torch.mean(q, dim=-1) * _norm(g)
    tc = torch.sum(cnt, dim=-1)
    return torch.where(tc > 0, torch.sum(q * cnt, dim=-1)
                       / torch.clamp_min(tc, 1), torch.zeros_like(tc)) \
        * _norm(g)


def _present(starts: torch.Tensor, C: int, g: Geom, sil) -> torch.Tensor:
    """1 where the frame at per-channel sample `starts` overlaps the
    non-silent interleaved range (src/syncfinder.cc:583-585)."""
    first, last = sil
    f0, f1 = starts * C, (starts + g.frame_size) * C
    return (~((f1 < first) | (f0 > last))).to(torch.float64)


class _Sync:
    """One key's sync frames for one mode, as band-selection matrices."""

    def __init__(self, lay: Layout, clip: bool, prec: Prec, device):
        g = lay.geom
        frames, up, dn = keyed.sync_bits(lay, clip)
        self.n_pos = frames.shape[1]
        self.frames = torch.from_numpy(frames.reshape(-1)).to(device)
        J = self.frames.shape[0]
        vu = np.zeros((J, g.n_bands))
        vd = np.zeros((J, g.n_bands))
        rows = np.arange(J)[:, None]
        vu[rows, up.reshape(J, -1)] = 1.0
        vd[rows, dn.reshape(J, -1)] = 1.0
        self.vu = torch.from_numpy(vu).to(device=device, dtype=prec.dtype)
        self.vd = torch.from_numpy(vd).to(device=device, dtype=prec.dtype)
        self.total = g.frames_per_block * (2 if clip else 1)

    def per_bit(self, a: torch.Tensor, g: Geom) -> torch.Tensor:
        """(J, ...) -> (..., sync_bits)."""
        return torch.movedim(torch.sum(a.reshape(
            g.sync_bits, self.n_pos, *a.shape[1:]), dim=1), 0, -1)


def sweep(x: torch.Tensor, sync: _Sync, g: Geom, prec: Prec, sil=None):
    """Raw quality of every start hop: (n_starts,) in prec.dtype."""
    n, C = x.shape
    F = n // g.frame_size
    n_taus = SHIFTS * (F - 1)
    n_starts = SHIFTS * (F - 1 - sync.total)
    if n_starts <= 0:
        return x.new_zeros(0)
    win = x.T.unfold(1, g.frame_size, g.sync_search_step)[:, :n_taus]
    S = torch.cat([torch.sum(db_bands(win[:, t:t + 8192], g, prec), dim=0)
                   for t in range(0, n_taus, 8192)])       # (n_taus, bands)
    S = prec.q(S)
    have = None
    if sil is not None:
        have = _present(torch.arange(n_taus, device=x.device)
                        * g.sync_search_step, C, g, sil).to(S.dtype)
        if bool(torch.all(have > 0)):
            have = None
    need = SHIFTS * int(sync.frames.max()) + n_starts
    S = torch.cat([S, S.new_zeros((max(need - n_taus, 0), S.shape[1]))])
    with prec.matmul():
        Du = prec.q(torch.matmul(sync.vu, S.T))             # (J, rows)
        Dd = prec.q(torch.matmul(sync.vd, S.T))
    if have is not None:
        have = torch.cat([have, have.new_zeros(S.shape[0] - n_taus)])
        Du, Dd = Du * have, Dd * have
    out = []
    for t0 in range(0, n_starts, 16384):
        rows = SHIFTS * sync.frames[:, None] + torch.arange(
            t0, min(t0 + 16384, n_starts), device=x.device)
        u = sync.per_bit(torch.gather(Du, 1, rows), g)
        d = sync.per_bit(torch.gather(Dd, 1, rows), g)
        cnt = None if have is None else sync.per_bit(have[rows], g)
        out.append(prec.q(_bit_quality(u, d, cnt, g)))
    return torch.cat(out)


def local_mean(q: np.ndarray, distance: int = 20,
               exclude: int = 4) -> np.ndarray:
    n = q.size
    tot = np.zeros(n)
    cnt = np.zeros(n)
    for j in list(range(-distance, -exclude + 1)) \
            + list(range(exclude, distance + 1)):
        lo, hi = max(0, -j), min(n, n - j)
        tot[lo:hi] += q[lo + j:hi + j]
        cnt[lo:hi] += 1
    return np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)


def local_maxima(aq: np.ndarray) -> np.ndarray:
    """The sequential scan of src/syncfinder.cc:258-281: a peak (>= both
    neighbours) is taken and its right neighbour skipped."""
    keep = np.zeros(aq.size, bool)
    i = 0
    while i < aq.size:
        left = aq[i - 1] if i > 0 else 0.0
        right = aq[i + 1] if i + 1 < aq.size else 0.0
        if aq[i] >= left and aq[i] >= right:
            keep[i] = True
            i += 2
        else:
            i += 1
    return keep


def mask_false_positives(idx: np.ndarray, raw: np.ndarray,
                         mean: np.ndarray, g: Geom) -> np.ndarray:
    """Drop candidates with an opposite-sign candidate three times larger
    within 23 hops (src/syncfinder.cc:283-332)."""
    aq = np.abs(raw - mean)
    sign = np.where(raw - mean < 0, -1, 1)
    drop = np.zeros(idx.size, bool)
    for d in range(1, min(23, idx.size - 1) + 1):
        near = ((idx[d:] - idx[:-d]) // g.sync_search_step <= 23) \
            & (sign[d:] != sign[:-d])
        drop[:-d] |= near & (aq[d:] > aq[:-d] * 3.0)
        drop[d:] |= near & (aq[:-d] > aq[d:] * 3.0)
    return ~drop


def best_order(aq: np.ndarray, threshold: float, n_best: int,
               extra: int) -> np.ndarray:
    """Indices by falling quality (ties in index order): all above the
    threshold, at least n_best, and `extra` more."""
    order = np.argsort(-aq, kind="stable")
    above = int(np.count_nonzero(aq > threshold))
    keep = above if above >= n_best else min(n_best, aq.size)
    return order[:min(keep + extra, aq.size)]


def _quality_at(x: torch.Tensor, pos: torch.Tensor, sync: _Sync, g: Geom,
                prec: Prec, sil=None) -> torch.Tensor:
    """Raw quality of the sync frames starting at sample positions pos."""
    n, C = x.shape
    F = g.frame_size
    starts = pos[:, None] + sync.frames[None, :] * F        # (P, J)
    ar = torch.arange(F, device=x.device)
    db = torch.cat([torch.sum(db_bands(x[(s[..., None] + ar).clamp_max(
        n - 1)].transpose(-1, -2), g, prec), dim=-2)        # (p, J, bands)
        for s in torch.split(starts, 16)])
    with prec.matmul():
        u = prec.q(torch.einsum("pjb,jb->pj", db, sync.vu))
        d = prec.q(torch.einsum("pjb,jb->pj", db, sync.vd))
    hv = torch.ones_like(u)
    if sil is not None:
        hv = _present(starts, C, g, sil).to(u.dtype)
    return prec.q(_bit_quality(sync.per_bit((u * hv).T, g),
                               sync.per_bit((d * hv).T, g),
                               sync.per_bit(hv.T, g), g))


def search(x: torch.Tensor, lay: Layout, clip: bool, prec: Prec,
           extra: int, sil=None, final: bool = True
           ) -> List[Tuple[int, float, str]]:
    """[(index, quality, block type)] by index, upstream's choice plus
    `extra` more at each cut; `final` False keeps every refined candidate
    (the fleet detector reports its top slots by the first cut alone)."""
    g = lay.geom
    sync = _Sync(lay, clip, prec, x.device)
    q = sweep(x, sync, g, prec, sil).double().cpu().numpy()
    if q.size == 0:
        return []
    mean = local_mean(q)
    aq = np.abs(q - mean)
    sel = np.nonzero(local_maxima(aq))[0]
    sel = sel[mask_false_positives(sel * g.sync_search_step, q[sel],
                                   mean[sel], g)]
    sel = sel[best_order(aq[sel], g.sync_threshold2 * 0.75, g.get_n_best,
                         extra)]
    if clip:
        sel = sel[:max(g.get_n_best, 5) + extra]
    n = x.shape[0]
    step, fine = g.sync_search_step, g.sync_search_fine
    refined, near = [], []
    for t in sel:
        base = int(t) * step
        lo = max(base - step, 0)
        pos = np.arange(lo, base + step + 1, fine)
        pos = pos[pos + sync.total * g.frame_size <= n]
        best_q, best_i = q[t], base
        qs = np.zeros(0)
        if pos.size:
            qs = _quality_at(x, torch.from_numpy(pos).to(x.device), sync, g,
                             prec, sil).double().cpu().numpy()
            for p, qq in zip(pos, qs):
                if abs(qq - mean[t]) > abs(best_q - mean[t]):
                    best_q, best_i = float(qq), int(p)
        refined.append((best_i, best_q, mean[t]))
        # positions whose quality ties the best to rounding: the program
        # may keep any of them
        near.append([(int(p), float(qq), mean[t]) for p, qq in zip(pos, qs)
                     if p != best_i and abs(abs(qq - mean[t])
                                            - abs(best_q - mean[t])) <= TIE]
                    if extra else [])
    order = np.argsort([r[0] for r in refined], kind="stable")
    refined = [refined[i] for i in order]
    near = [near[i] for i in order]
    aq2 = np.array([abs(r[1] - r[2]) for r in refined])
    keep = sorted(best_order(aq2, g.sync_threshold2, g.get_n_best, extra)
                  if final else range(len(refined)))
    out = []
    for i in keep:
        for idx, rq, m in [refined[i]] + near[i]:
            out.append((idx, abs(rq - m), "a" if rq - m > 0 else "b"))
    return sorted(out)


# ---- extraction and decode ------------------------------------------------

def raw_bits(x: torch.Tensor, index: int, lay: Layout,
             prec: Prec) -> Optional[np.ndarray]:
    """De-interleaved raw soft bits of the block at `index`, or None where
    it reads past the end."""
    g = lay.geom
    count, F = g.frames_per_block, g.frame_size
    n, C = x.shape
    if index + count * F > n:
        return None
    w = x[index:index + count * F].reshape(count, F, C).transpose(1, 2)
    db = db_bands(w, g, prec)                               # (count, C, NB)
    nxt = torch.arange(1, count + 1)
    nxt[-1] = count - 2
    prv = torch.arange(-1, count - 1)
    prv[0] = 1
    A = prec.q(torch.sum(db - 0.5 * (db[prv] + db[nxt]), dim=1))
    fr = torch.from_numpy(lay.mix_frame).to(x.device)
    u = A[fr, torch.from_numpy(lay.mix_up - g.min_band).to(x.device)]
    d = A[fr, torch.from_numpy(lay.mix_dn - g.min_band).to(x.device)]
    raw = prec.q(torch.sum((u - d).reshape(-1, g.bands_per_frame
                                           * g.frames_per_bit), dim=1))
    raw = raw.double().cpu().numpy()
    out = np.empty_like(raw)
    out[lay.bit_order] = raw
    return out


def normalize(v: np.ndarray) -> np.ndarray:
    return 0.5 * (v / np.mean(np.abs(v)) + 1.0)


def viterbi(rows: np.ndarray, block_type: str, n_msg: int, prec: Prec,
            device) -> Tuple[np.ndarray, np.ndarray]:
    """Soft decode of (B, n_coded) rows in [0, 1] -> (bits (B, n_msg),
    errors (B,))."""
    S = torch.from_numpy(keyed.parity_table(block_type)).to(
        device=device, dtype=prec.dtype)                    # (states, rate)
    rate = S.shape[1]
    c = prec.q(torch.from_numpy(rows).to(device=device, dtype=prec.dtype))
    B = c.shape[0]
    c = c.reshape(B, -1, rate)
    steps = c.shape[1]
    c_sq = torch.sum(c * c, dim=2, keepdim=True)
    s_sum = torch.sum(S, dim=1)
    half = keyed.STATES // 2
    metric = torch.full((B, keyed.STATES), 1e9, dtype=prec.dtype,
                        device=device)
    metric[:, 0] = 0.0
    dec = torch.empty((B, steps, half), dtype=torch.bool, device=device)
    for t in range(steps):
        with prec.matmul():
            bm = prec.q(c_sq[:, t] - 2.0 * torch.matmul(c[:, t], S.T)
                        + s_sum)
        lo, hi = metric[:, :half], metric[:, half:]
        dec[:, t] = hi < lo
        metric = prec.q(torch.where(dec[:, t], hi, lo)
                        .repeat_interleave(2, dim=1) + bm)
    state = torch.zeros(B, dtype=torch.int64, device=device)
    bits = torch.empty((B, steps), dtype=torch.int64, device=device)
    rows_i = torch.arange(B, device=device)
    for t in range(steps - 1, -1, -1):
        bits[:, t] = state & 1
        pair = state >> 1
        state = pair | (dec[rows_i, t, pair].to(torch.int64)
                        << (keyed.ORDER - 1))
    errors = (metric[:, 0] / (steps * rate)).double().cpu().numpy()
    return bits[:, :n_msg].cpu().numpy(), errors


# ---- patterns --------------------------------------------------------------

def _all_chain(blocks: List[RefPattern], g: Geom) -> List[int]:
    """upstream's greedy chain of alternating blocks at block spacing
    (src/wmget.cc:606-701); indices into `blocks` (index-ordered)."""
    step = g.frames_per_block * g.frame_size
    best: List[int] = []

    def qsum(ch):
        return sum(blocks[b].quality for b in ch)

    for i in range(len(blocks)):
        max_idx = int(round(blocks[-1].index / float(step) + 0.5))
        chain = [i]
        k = 1
        while k <= max_idx:
            expect = blocks[chain[-1]].index + k * step
            best_j, best_d = -1, k * g.frame_size // 2
            bt = blocks[chain[-1]].block_type
            if k & 1:
                bt = "b" if bt == "a" else "a"
            for j in range(chain[-1], len(blocks)):
                dist = abs(expect - blocks[j].index)
                if dist < best_d and blocks[j].block_type == bt:
                    best_j, best_d = j, dist
            if best_j >= 0:
                chain.append(best_j)
                k = 1
            else:
                k += 1
        if qsum(chain) > qsum(best):
            best = chain
    return best if len(best) > 1 else []


def _interleave(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    out = np.empty(first.size * 2)
    out[0::2], out[1::2] = first, second
    return out


def _silence(v: np.ndarray) -> Tuple[int, int]:
    nz = np.nonzero(v)[0]
    return (0, 0) if nz.size == 0 else (int(nz[0]), int(nz[-1]) + 1)


def reference_patterns(samples: np.ndarray, key: bytes, g: Geom,
                       prec: Prec, device, extra: int = 8,
                       clip: bool = True) -> List[RefPattern]:
    """Every pattern `get` could report on int16 (n, C) samples at 44.1
    kHz, each with its soft bits, decoded; `clip` False leaves out the
    clip windows and the second cut of the superset's block candidates
    (the fleet detector has neither)."""
    lay = keyed.layout(key, g)
    x = prec.q(torch.from_numpy(np.ascontiguousarray(samples)).to(
        device=device, dtype=prec.dtype) / 32768.0)
    n, C = x.shape
    count = g.frames_per_block * g.frame_size
    pats: List[RefPattern] = []

    # block candidates, upstream's selection alone (for the chain) and the
    # superset
    cands = {e: search(x, lay, False, prec, e, final=clip or e == 0)
             for e in sorted({0, extra})}
    core = set(cands[0])
    soft = {}
    for c in cands[extra]:
        idx, q, bt = c
        r = raw_bits(x, idx, lay, prec)
        if r is not None:
            soft[idx] = r
            pats.append(RefPattern("block", bt, idx, q, soft=r,
                                   core=c in core))
    blocks = [p for p in pats if p.kind == "block"]
    for b in blocks:
        if b.block_type != "b":
            continue
        for a in blocks:
            if a.block_type == "a" and a.index < b.index and \
                    abs((b.index - a.index) - count) < g.frame_size // 2:
                pats.append(RefPattern("block", "ab", b.index,
                                       (a.quality + b.quality) / 2,
                                       soft=_interleave(a.soft, b.soft)))
    for e in sorted({0, extra}):
        chain_blocks = [RefPattern("block", bt, idx, q, soft=soft[idx])
                        for idx, q, bt in cands[e] if idx in soft]
        chain = _all_chain(chain_blocks, g)
        if chain:
            acc = [np.zeros(g.coded_bits), np.zeros(g.coded_bits)]
            norm = [0, 0]
            for i in chain:
                ab = 1 if chain_blocks[i].block_type == "b" else 0
                acc[ab] += chain_blocks[i].soft
                norm[ab] += 1
            q = sum(chain_blocks[i].quality for i in chain) / len(chain)
            pats.append(RefPattern("all", "ab", 0, q, soft=_interleave(
                acc[0] / max(norm[0], 1), acc[1] / max(norm[1], 1))))

    # clip windows of short streams
    if clip and n // g.frame_size < g.frames_per_block * 3.1:
        pad = (g.frames_per_block + 5) * g.frame_size
        windows = [(0, np.concatenate([np.zeros((pad + max(pad - n, 0), C),
                                                np.int16),
                                       samples[:pad],
                                       np.zeros((pad, C), np.int16)]))]
        if n > pad:
            windows.append((n - pad, np.concatenate([
                np.zeros((pad, C), np.int16), samples[n - pad:],
                np.zeros((pad, C), np.int16)])))
        for start, w in windows:
            xw = prec.q(torch.from_numpy(w).to(device=device,
                                               dtype=prec.dtype) / 32768.0)
            sil = _silence(w.reshape(-1))
            for idx, q, bt in search(xw, lay, True, prec, extra, sil):
                r1 = raw_bits(xw, idx, lay, prec)
                r2 = raw_bits(xw, idx + count, lay, prec)
                if r1 is None or r2 is None:
                    continue
                pair = (r1, r2) if bt == "a" else (r2, r1)
                pats.append(RefPattern("clip", bt, start, q,
                                       soft=_interleave(*pair)))

    # one trellis per code rate: A and B blocks at 6, the rest at 12
    def code(p):
        return p.block_type if p.kind == "block" and p.block_type != "ab" \
            else "ab"

    for bt in ("a", "b", "ab"):
        group = [p for p in pats if code(p) == bt]
        if group:
            bits, errs = viterbi(np.stack([normalize(p.soft) for p in group]),
                                 bt, g.payload_size, prec, device)
            for p, b, e in zip(group, bits, errs):
                p.bits, p.error = b, float(e)
    return pats
