"""The walk orders of the widen kernels K4 (``csrc/dtw_lane.cu``) and K5
(``csrc/dtw_tile_stripe.cu``) as small NumPy models, on the CPU.

The kernels run only on the card; their index arithmetic is modelled here
step for step and held against the JAX kernels in interpret mode, the NumPy
oracle and the port's plain twin:

- K4: one thread per B sequence, strips of R rows, each row on the columns
  of its own band, each warp walking the union of its threads' bands, and
  the boundary row between strips in the class frame (slot s of row i is
  column i + s - (wv+1)), rewritten in place R slots behind the reads;
- K5: one warp per pair, strips of R rows over the window
  [i0 - pw, i0+R-1 + pw], panels of lanes*cw columns with each lane on a
  contiguous run, the row's left dependency by a min-plus scan over the
  lanes' maps, the row carries from panel to panel, and the boundary row
  in its band's frame.

Shared-memory slots start as a finite garbage value, so a read of a slot
the walk never wrote shows up in the distance; every slot index is checked
against its array.  Tolerances are those of ``tests/test_torch_dtw_lane.py``
against JAX (rtol 1e-4; atol 1e-4, 1e-3 on self tiles: the JAX kernels
build costs from a Gram expansion) and rtol 1e-5 against the oracle and
the twin (float64 model against float32 and float64 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)

TI, S, D, R = 8, 32, 4, 4
PAIRS = ([0, 0, 1], [0, 1, 1])
INF = np.inf
GARBAGE = -1.0e6


def _costs(a, b, metric):
    """[la, lb] cell costs of A frames a against B frames b."""
    if metric == "cosine":
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        return 1.0 - a @ b.T
    c = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.sqrt(c) if metric == "euclidean" else c


def _half_width(la, lb, band, auto_widen):
    diff = abs(la - lb)
    return diff if auto_widen and diff > band else band


def k4_walk(feats, lens, I, J, *, band, wv, auto_widen=True, metric="euclidean",
            rows=None, warp=32):
    """[ti, ti] distances of tile-pair (I, J) in K4's walk order: a block per
    A row, a thread per B sequence, ``warp`` threads to a warp."""
    rows = S if rows is None else rows
    W, off = 2 * wv + 2, wv + 1
    out = np.full((TI, TI), INF)
    for r in range(TI):
        la = int(lens[I * TI + r])
        if la < 1 or la > rows:
            continue
        lb = [int(lens[J * TI + c]) for c in range(TI)]
        pw = [_half_width(la, lb[c], band, auto_widen) for c in range(TI)]
        ok = [1 <= lb[c] <= S and pw[c] <= wv and abs(la - lb[c]) <= pw[c] for c in range(TI)]
        pw_w, jmax_w = {}, {}
        for c in range(TI):
            g = c // warp
            pw_w[g] = max(pw_w.get(g, 0), pw[c] if ok[c] else 0)
            jmax_w[g] = max(jmax_w.get(g, -1), lb[c] - 1 if ok[c] else -1)
        stripe = np.full((TI, W), GARBAGE)
        for c in range(TI):
            if not ok[c]:
                continue
            C = _costs(feats[I * TI + r, :la], feats[J * TI + c, :lb[c]], metric)
            p, g = pw[c], c // warp
            for i0 in range(0, la, R):
                last = i0 + R >= la
                lo = [max(0, i - p) if i < la else 1 for i in range(i0, i0 + R)]
                hi = [min(lb[c] - 1, i + p) if i < la else 0 for i in range(i0, i0 + R)]
                ulo = max(0, i0 - 1 - p) if i0 > 0 else 1
                uhi = min(lb[c] - 1, i0 - 1 + p) if i0 > 0 else 0
                sb = off - i0 + 1
                j_lo = max(0, i0 - pw_w[g])
                j_hi = min(jmax_w[g], i0 + R - 1 + pw_w[g])

                def read(j):
                    if not ulo <= j <= uhi:
                        return INF
                    assert 0 <= j + sb < W
                    return stripe[c, j + sb]

                left = [INF] * R
                bdiag = 0.0 if i0 == 0 else read(j_lo - 1)
                for j in range(j_lo, j_hi + 1):
                    up0 = read(j)
                    up, diag, bdiag = up0, bdiag, up0
                    for k in range(R):
                        cost = C[i0 + k, j] if lo[k] <= j <= hi[k] else INF
                        v = cost + min(diag, up, left[k])
                        diag, left[k], up = left[k], v, v
                    if not last:
                        sw = j - (i0 + R - 1) + off
                        assert sw < W
                        if sw >= 0:
                            stripe[c, sw] = up
                    elif j == lb[c] - 1:
                        out[r, c] = left[la - 1 - i0]
    return out


def k5_walk(feats, lens, I, J, *, band, wv, auto_widen=True, metric="euclidean",
            rows=None, lanes=32, cw_max=8):
    """[ti, ti] distances of tile-pair (I, J) in K5's walk order: a warp of
    ``lanes`` lanes per pair, runs of at most ``cw_max`` columns a lane."""
    rows = S if rows is None else rows
    out = np.full((TI, TI), INF)
    for r in range(TI):
        for c in range(TI):
            la, lb = int(lens[I * TI + r]), int(lens[J * TI + c])
            pw = _half_width(la, lb, band, auto_widen)
            if la < 1 or lb < 1 or la > rows or lb > S or pw > wv or abs(la - lb) > pw:
                continue
            C = _costs(feats[I * TI + r, :la], feats[J * TI + c, :lb], metric)
            out[r, c] = _k5_pair(C, la, lb, pw, wv, lanes, cw_max)
    return out


def _k5_pair(C, la, lb, pw, wv, L, CW):
    bnd = np.full(2 * wv + 1, GARBAGE)
    result = None
    for i0 in range(0, la, R):
        last = i0 + R >= la
        kn = min(R, la - i0)
        lo = [max(0, i - pw) for i in range(i0, i0 + R)]
        hi = [min(lb - 1, i + pw) for i in range(i0, i0 + R)]
        ulo = max(0, i0 - 1 - pw) if i0 > 0 else 1
        uhi = min(lb - 1, i0 - 1 + pw) if i0 > 0 else 0
        sb = pw - i0 + 1
        w_lo, w_hi = max(0, i0 - pw), min(lb - 1, i0 + R - 1 + pw)

        def read(j):
            if not ulo <= j <= uhi:
                return INF
            assert 0 <= j + sb < len(bnd)
            return bnd[j + sb]

        carry = [INF] * R
        p0 = w_lo
        while p0 <= w_hi:
            n = w_hi - p0 + 1
            cw = CW if n >= L * CW else -(-n // L)
            cols = p0 + np.arange(L)[:, None] * cw + np.arange(cw)[None, :]   # [L, cw]
            cst = np.full((R, L, cw), INF)
            for k in range(kn):
                m = (cols >= lo[k]) & (cols <= hi[k])
                cst[k][m] = C[i0 + k, cols[m]]
            dv = np.array([[read(j) for j in row] for row in cols])
            dg = (0.0 if p0 == 0 else INF) if i0 == 0 else read(p0 - 1)
            for k in range(kn):
                dl = np.concatenate([[dg], dv[:-1, -1]])          # lane l-1's last column
                diag = np.concatenate([dl[:, None], dv[:, :-1]], axis=1)
                e = cst[k] + np.minimum(diag, dv)
                P, Q = np.zeros(L), np.full(L, INF)
                for t in range(cw):
                    P, Q = P + cst[k][:, t], np.minimum(Q + cst[k][:, t], e[:, t])
                sh = 1
                while sh < L:                                      # inclusive scan
                    Pp, Qp = np.roll(P, sh), np.roll(Q, sh)
                    take = np.arange(L) >= sh
                    P, Q = np.where(take, Pp + P, P), np.where(take, np.minimum(Qp + P, Q), Q)
                    sh *= 2
                old = carry[k]
                left = np.concatenate([[old], np.minimum(old + P[:-1], Q[:-1])])
                for t in range(cw):
                    dv[:, t] = np.minimum(e[:, t], left + cst[k][:, t])
                    left = dv[:, t]
                if i0 + k == la - 1:
                    hit = cols == lb - 1
                    if hit.any():
                        result = dv[hit][0]
                carry[k] = left[-1]
                dg = old
            if not last:
                i = i0 + R - 1
                for j, v in zip(cols.ravel(), dv.ravel()):
                    if lo[R - 1] <= j <= hi[R - 1]:
                        assert 0 <= j - i + pw < len(bnd)
                        bnd[j - i + pw] = v
            p0 += L * cw
    return result


def _mk(seed, lo=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (2 * TI, S, D)).astype(np.float32)
    lengths = rng.integers(lo, S + 1, 2 * TI).astype(np.int32)
    return feats, lengths


def _jax_lane(feats, lengths, I, J, **kw):
    return np.asarray(jp.dtw_tile_lane_pairs(
        jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(I, jnp.int32),
        jnp.asarray(J, jnp.int32), ti=TI, unroll_rows=1, interpret=True, **kw,
    ))


def _twin(feats, lengths, I, J, **kw):
    return tk.dtw_tile_lane_pairs_ref(
        torch.from_numpy(feats), torch.from_numpy(lengths), torch.tensor(I, dtype=torch.int32),
        torch.tensor(J, dtype=torch.int32), ti=TI, **kw,
    ).numpy()


def _assert_blocks(got, want, I, J, rtol=1e-4):
    for u in range(len(I)):
        g, w = got[u].copy(), want[u].copy()
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        atol = 1e-4
        if I[u] == J[u] and rtol > 1e-5:
            np.fill_diagonal(g, 0.0)
            np.fill_diagonal(w, 0.0)
            atol = 1e-3
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol if rtol > 1e-5 else 1e-5)


def _walks(feats, lengths, I, J, **kw):
    """K4's walk (warps of 32 and of 4 threads) and K5's (the kernel's 32
    lanes with runs of 8, and 4 lanes with runs of 2, many panels)."""
    return {
        "k4": np.stack([k4_walk(feats, lengths, i, j, **kw) for i, j in zip(I, J)]),
        "k4 warp 4": np.stack([k4_walk(feats, lengths, i, j, warp=4, **kw) for i, j in zip(I, J)]),
        "k5": np.stack([k5_walk(feats, lengths, i, j, **kw) for i, j in zip(I, J)]),
        "k5 panels": np.stack([k5_walk(feats, lengths, i, j, lanes=4, cw_max=2, **kw)
                               for i, j in zip(I, J)]),
    }


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=4, auto_widen=True, metric="euclidean"),
        dict(band=4, auto_widen=False, metric="euclidean"),
        dict(band=3, auto_widen=True, metric="cosine"),
    ],
)
def test_walks_match_jax_kernel_and_twin(kw):
    feats, lengths = _mk(31)
    wv = int(np.ptp(lengths))
    want = _jax_lane(feats, lengths, *PAIRS, wv_max=wv, **kw)
    twin = _twin(feats, lengths, *PAIRS, wv_max=wv, **kw)
    for name, got in _walks(feats, lengths, *PAIRS, wv=wv, **kw).items():
        _assert_blocks(got, want, *PAIRS)
        _assert_blocks(got, twin, *PAIRS, rtol=1e-5)
    if not kw["auto_widen"]:
        assert np.isinf(twin).any()


def test_walks_of_length_one_sequences_match_oracle():
    feats, lengths = _mk(32)
    lengths[[0, 1, TI, TI + 1]] = [1, 2, 1, 5]
    wv = int(np.ptp(lengths))
    I, J = [0, 0], [0, 1]
    for name, got in _walks(feats, lengths, I, J, band=2, wv=wv).items():
        for u, Jt in enumerate(J):
            for r in range(TI):
                for c in range(TI):
                    b = Jt * TI + c
                    want = dtw_oracle(feats[r, : lengths[r]], feats[b, : lengths[b]], band=2,
                                      band_mode="widen")
                    assert np.isclose(got[u, r, c], want, rtol=1e-5, atol=1e-5), (name, u, r, c)


def test_walk_shortfalls_are_inf_on_exactly_the_cut_pairs():
    feats, lengths = _mk(33)
    wv = int(np.ptp(lengths))
    la, lb = lengths[:TI, None], lengths[TI:][None, :]
    full = _walks(feats, lengths, [0], [1], band=4, wv=wv)
    rows = int(np.sort(lengths[:TI])[TI // 2])
    short = int(np.median(np.abs(la - lb)))
    for tag, kw, cut in (
        ("rows", dict(wv=wv, rows=rows), np.broadcast_to(la > rows, (TI, TI))),
        ("wv_max", dict(wv=short), np.abs(la - lb) > short),
    ):
        assert cut.any() and (~cut).any()
        for name, got in _walks(feats, lengths, [0], [1], band=4, **kw).items():
            assert np.isinf(got[0][cut]).all(), (tag, name)
            np.testing.assert_array_equal(got[0][~cut], full[name][0][~cut])


def test_walks_cover_narrow_and_wide_bands():
    # A class bound far above the pairs' own bands (K4's warp union, K5's
    # windows) and wide pairs over many K5 panels: the same distances.
    feats, lengths = _mk(34, lo=2)
    wv = S
    twin = _twin(feats, lengths, *PAIRS, band=1, wv_max=wv)
    for name, got in _walks(feats, lengths, *PAIRS, band=1, wv=wv).items():
        _assert_blocks(got, twin, *PAIRS, rtol=1e-5)
    wide = k5_walk(feats, lengths, 0, 1, band=12, wv=wv, lanes=2, cw_max=1)
    _assert_blocks(wide[None], _twin(feats, lengths, [0], [1], band=12, wv_max=wv), [0], [1],
                   rtol=1e-5)
