"""The systolic walk of K3 (``csrc/dtw_lane_full.cu``), K6
(``csrc/dtw_rowscan.cu``) and K7 (``csrc/dtw_stripe.cu``), shared in
``csrc/dtw_systolic.cuh``, as a NumPy model step for step, on the CPU.

The kernels run only on the card; their index arithmetic is modelled here
and held against the JAX kernels in interpret mode
(``dtw_tile_lane_full_pairs``, ``dtw_batch_pallas``, ``_dtw_batch_stripe``),
the NumPy oracle and the port's plain twins:

- a group of G lanes per pair (K3 and K7 a warp, K6 32/G pairs a warp); a
  pass covers G*R rows, lane l owning rows i0 + l*R .. i0 + l*R + R-1 and
  computing at step t their cells of column j = c_lo + t - l, top to bottom;
- the value above a lane's first row is lane l-1's bottom cell of the same
  column from the step before (one shuffle of the group's width a step),
  the diagonal the previous step's shuffled value; the group's lane 0
  reads the pass boundary row and its last lane writes it, in place; the
  distance is the corner lane's row at the last pass's last column;
- K3: the window is every column of B, the boundary row indexed by column,
  the class contracts (``width``, ``rows``) +inf (rows past la are +inf
  here; the kernel lets them compute on zero frames, which reach no live
  row);
- K7: the window is the pass's own band [max(0, i0 - pw), min(lb-1,
  i_last + pw)], the boundary row in its band's frame (slot j - i + pw),
  and the max_len_diff, rows and hard-band contracts +inf;
- K6: K7's window with pw = S unbanded (every column), the boundary row of
  each group in absolute columns, the groups of a warp stepped together to
  the longest window among them and the warp's passes to the longest pair,
  and the rows and band contracts +inf.

Boundary rows start as a finite garbage value, so a read of a slot that the
walk never wrote shows in the distance; every slot index is checked against
its array.  Tolerances: rtol 1e-4 / atol 1e-4 against JAX (its kernels
build costs from a Gram expansion; self pairs skipped), rtol 1e-5 / atol
1e-5 against the oracle and the twins (float64 model against float64 and
float32 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)

INF = np.inf
GARBAGE = -1.0e6


def _costs(a, b, metric):
    """[la, lb] cell costs of A frames a against B frames b."""
    if metric == "cosine":
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        return 1.0 - a @ b.T
    c = ((a[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(-1)
    return np.sqrt(c) if metric == "euclidean" else c


def systolic_pass(C, i0, lanes, R, c_lo, c_hi, lo, hi, diag0, up_of, down):
    """One pass of ``apd_systolic::pass``: lo, hi [lanes, R] the columns of
    each lane's rows' cells.  Returns ``left`` [lanes, R]: each lane's rows
    at its last column, c_hi."""
    left = np.full((lanes, R), INF)
    bottom = np.full(lanes, INF)
    up_prev = np.full(lanes, INF)
    up_prev[0] = diag0
    for t in range(c_hi - c_lo + lanes):
        shuffled = np.roll(bottom, 1)                 # lane l gets lane l-1's
        new_bottom = bottom.copy()
        for lane in range(lanes):
            j = c_lo + t - lane
            on = c_lo <= j <= c_hi
            up = shuffled[lane]
            if lane == 0:
                up = up_of(j) if on else INF
            diag, up_prev[lane] = up_prev[lane], up
            if not on:
                continue
            for k in range(R):
                cost = C[i0 + lane * R + k, j] if lo[lane, k] <= j <= hi[lane, k] else INF
                v = cost + min(diag, up, left[lane, k])
                diag, left[lane, k], up = left[lane, k], v, v
            new_bottom[lane] = up
            if lane == lanes - 1:
                down(j, up)
        bottom = new_bottom
    return left


def _rows(i0, lanes, R):
    return i0 + np.arange(lanes)[:, None] * R + np.arange(R)[None, :]   # [lanes, R]


def _corner(left, la, i0, R):
    """D[la-1, c_hi] from the last pass's ``left``: c_hi is lb-1 there."""
    c = la - 1 - i0
    return left[c // R, c % R]


def k3_pair(C, la, lb, *, lanes, R, W):
    """K3's walk of one pair (contracts already met): the boundary row
    indexed by column, [W] slots."""
    bnd = np.full(W, GARBAGE)
    for i0 in range(0, la, lanes * R):
        rows = _rows(i0, lanes, R)
        live = rows < la
        lo, hi = np.where(live, 0, 1), np.where(live, lb - 1, 0)
        nxt = i0 + lanes * R < la

        def up_of(j):
            if i0 == 0:
                return INF
            assert 0 <= j < W
            return bnd[j]

        def down(j, v):
            if nxt:
                assert 0 <= j < W
                bnd[j] = v

        left = systolic_pass(C, i0, lanes, R, 0, lb - 1, lo, hi,
                             0.0 if i0 == 0 else INF, up_of, down)
    return _corner(left, la, i0, R)


def k3_walk(feats, lens, I, J, *, ti, width, rows, metric="euclidean", lanes=32, R=4):
    """[ti, ti] distances of tile-pair (I, J) in K3's walk order."""
    W = 8 * -(-width // 8)
    out = np.full((ti, ti), INF)
    for r in range(ti):
        for c in range(ti):
            la, lb = int(lens[I * ti + r]), int(lens[J * ti + c])
            if not (1 <= la <= rows and 1 <= lb <= W):
                continue
            C = _costs(feats[I * ti + r, :la], feats[J * ti + c, :lb], metric)
            out[r, c] = k3_pair(C, la, lb, lanes=lanes, R=R, W=W)
    return out


def k7_pair(C, la, lb, pw, wv, *, lanes, R):
    """K7's walk of one pair (contracts already met): the boundary row in
    its band's frame, [2*wv+1] slots."""
    bnd = np.full(2 * wv + 1, GARBAGE)
    for i0 in range(0, la, lanes * R):
        rows = _rows(i0, lanes, R)
        live = rows < la
        lo = np.where(live, np.maximum(rows - pw, 0), 1)
        hi = np.where(live, np.minimum(rows + pw, lb - 1), 0)
        i_last = min(i0 + lanes * R - 1, la - 1)
        c_lo, c_hi = max(0, i0 - pw), min(lb - 1, i_last + pw)
        ulo = max(0, i0 - 1 - pw) if i0 > 0 else 1
        uhi = min(lb - 1, i0 - 1 + pw) if i0 > 0 else 0
        sb = pw - i0 + 1
        nxt = i0 + lanes * R < la
        ib = i0 + lanes * R - 1

        def up_of(j):
            if not ulo <= j <= uhi:
                return INF
            assert 0 <= j + sb < len(bnd)
            return bnd[j + sb]

        def down(j, v):
            if nxt and ib - pw <= j <= ib + pw:
                assert 0 <= j - ib + pw < len(bnd)
                bnd[j - ib + pw] = v

        left = systolic_pass(C, i0, lanes, R, c_lo, c_hi, lo, hi,
                             0.0 if i0 == 0 else up_of(c_lo - 1), up_of, down)
    return _corner(left, la, i0, R)


def k7_walk(a, b, la, lb, *, band, wv, auto_widen=True, metric="euclidean", lanes=32, R=2):
    """[B] unnormalized distances of gathered pairs in K7's walk order."""
    out = np.full(len(la), INF)
    for p in range(len(la)):
        n, m = int(la[p]), int(lb[p])
        diff = abs(n - m)
        pw = diff if auto_widen and diff > band else band
        if n < 1 or m < 1 or n > a.shape[1] or m > b.shape[1] or pw > wv or diff > pw:
            continue
        out[p] = k7_pair(_costs(a[p, :n], b[p, :m], metric), n, m, pw, wv, lanes=lanes, R=R)
    return out


# (lanes, R): the kernel's 32 lanes at the two row counts the wrappers take
# at d <= 16, and 4 lanes, whose short passes make many pass boundaries.
GEOMETRIES = [(32, 2), (32, 4), (4, 2), (4, 1)]
TI, S_K3, D = 4, 72, 3


def _k3_corpus(seed, lo=5):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(lo, S_K3 + 1, 2 * TI)).astype(np.int32)
    feats = rng.normal(0, 1, (2 * TI, S_K3, D)).astype(np.float32)
    return feats, lens


def _k3_jax(feats, lens, ii, jj, **kw):
    return np.asarray(jp.dtw_tile_lane_full_pairs(
        jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(ii, jnp.int32),
        jnp.asarray(jj, jnp.int32), ti=TI, interpret=True, **kw))


def _k3_twin(feats, lens, ii, jj, **kw):
    return tk.dtw_tile_lane_full_pairs_ref(
        torch.from_numpy(feats), torch.from_numpy(lens), torch.tensor(ii, dtype=torch.int32),
        torch.tensor(jj, dtype=torch.int32), ti=TI, **kw).numpy()


@pytest.mark.parametrize("lanes,R", GEOMETRIES)
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_k3_walk_matches_jax_oracle_and_twin(lanes, R, metric):
    # Lengths 5-72: la not a multiple of lanes*R, one to several passes.
    feats, lens = _k3_corpus(41)
    ii, jj = [0, 0, 1], [0, 1, 1]
    kw = dict(width=int(lens.max()), rows=int(lens.max()), metric=metric)
    got = np.stack([k3_walk(feats, lens, i, j, ti=TI, lanes=lanes, R=R, **kw)
                    for i, j in zip(ii, jj)])
    want, twin = _k3_jax(feats, lens, ii, jj, **kw), _k3_twin(feats, lens, ii, jj, **kw)
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)
    for u, (I, J) in enumerate(zip(ii, jj)):
        off_diag = ~np.eye(TI, dtype=bool) if I == J else np.ones((TI, TI), bool)
        np.testing.assert_allclose(got[u][off_diag], want[u][off_diag], rtol=1e-4, atol=1e-4)
        for r in range(TI):
            for c in range(TI):
                a, b = I * TI + r, J * TI + c
                ref = dtw_oracle(feats[a, :lens[a]], feats[b, :lens[b]], metric=metric)
                assert np.isclose(got[u, r, c], ref, rtol=1e-5, atol=1e-5), (u, r, c)


def test_k3_walk_shortfalls_are_inf_on_exactly_the_cut_pairs():
    feats, lens = _k3_corpus(42, lo=20)
    full_kw = dict(width=int(lens.max()), rows=int(lens.max()))
    full = k3_walk(feats, lens, 0, 1, ti=TI, **full_kw)
    w_cut = 8 * (int(np.median(lens[TI:])) // 8)
    r_cut = int(np.median(lens[:TI]))
    for tag, kw, cut in (
        ("width", dict(width=w_cut, rows=full_kw["rows"]),
         np.broadcast_to(lens[TI:][None, :] > w_cut, (TI, TI))),
        ("rows", dict(width=full_kw["width"], rows=r_cut),
         np.broadcast_to(lens[:TI][:, None] > r_cut, (TI, TI))),
    ):
        assert cut.any() and (~cut).any(), tag
        for lanes, R in GEOMETRIES:
            got = k3_walk(feats, lens, 0, 1, ti=TI, lanes=lanes, R=R, **kw)
            assert np.isinf(got[cut]).all(), (tag, lanes, R)
            np.testing.assert_allclose(got[~cut], full[~cut], rtol=1e-12)
        twin = _k3_twin(feats, lens, [0], [1], **kw)[0]
        np.testing.assert_array_equal(np.isinf(twin), cut)


def _k7_pairs(seed, B, mld, lo=20, hi=80, Ra=128, S=512):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, Ra, D)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    la = rng.integers(lo, hi + 1, B).astype(np.int32)
    lb = np.minimum(la + rng.integers(0, mld + 1, B), S).astype(np.int32)
    swap = rng.random(B) < 0.5                         # either side the longer
    la, lb = np.where(swap, lb, la), np.where(swap, la, lb)
    return a, b, la.astype(np.int32), lb.astype(np.int32)


def _k7_twin(a, b, la, lb, **kw):
    return tk._dtw_batch_stripe_ref(*[torch.from_numpy(x) for x in (a, b, la, lb)],
                                    **kw).numpy()


@pytest.mark.parametrize("lanes,R", GEOMETRIES)
@pytest.mark.parametrize("band,mld", [(2, 6), (8, 40)])
def test_k7_walk_matches_jax_oracle_and_twin(lanes, R, band, mld):
    # A narrow band (pw 2-6) and a wide one (pw 8-40) at S=512, where the
    # reference's 128-slot stripe applies; lengths 20-90 (la not a multiple
    # of lanes*R), either side the longer.
    assert tk.stripe_width(512, band, True, mld) == 128
    a, b, la, lb = _k7_pairs(43 + band, 6, mld)
    wv = max(band, mld)
    got = k7_walk(a, b, la, lb, band=band, wv=wv, lanes=lanes, R=R)
    kw = dict(band=band, auto_widen=True, max_len_diff=mld)
    np.testing.assert_allclose(got, _k7_twin(a, b, la, lb, **kw), rtol=1e-5, atol=1e-5)
    want = np.asarray(jp._dtw_batch_stripe(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), metric="euclidean",
        normalize="none", pair_block=8, interpret=True, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for p in range(len(la)):
        ref = dtw_oracle(a[p, :la[p]], b[p, :lb[p]], band=band, band_mode="widen")
        assert np.isclose(got[p], ref, rtol=1e-5, atol=1e-5), p


def test_k7_walk_shortfalls_are_inf_on_exactly_the_cut_pairs():
    a, b, la, lb = _k7_pairs(47, 8, 40)
    full = k7_walk(a, b, la, lb, band=8, wv=40)
    assert np.isfinite(full).all()
    diff = np.abs(la.astype(int) - lb)
    r_cut = int(np.median(la))
    for tag, kw, cut, twin_kw in (
        ("max_len_diff", dict(band=8, wv=20), diff > 20, dict(band=8, max_len_diff=20)),
        ("hard band", dict(band=8, wv=8, auto_widen=False), diff > 8,
         dict(band=8, auto_widen=False)),
        ("rows", dict(band=8, wv=40), la > r_cut, dict(band=8, max_len_diff=40)),
    ):
        assert cut.any() and (~cut).any(), tag
        a_t = a[:, :r_cut] if tag == "rows" else a
        for lanes, R in GEOMETRIES:
            got = k7_walk(a_t, b, la, lb, lanes=lanes, R=R, **kw)
            assert np.isinf(got[cut]).all(), (tag, lanes, R)
            np.testing.assert_allclose(got[~cut], full[~cut], rtol=1e-12)
        np.testing.assert_array_equal(np.isinf(_k7_twin(a_t, b, la, lb, **twin_kw)), cut)


def test_walk_one_pass_per_lane_row_and_length_one():
    # Lengths at the pass boundaries (lanes*R - 1, lanes*R, lanes*R + 1) and
    # of length 1 on either side, K3 and K7 alike, against the oracle.
    rng = np.random.default_rng(48)
    lanes, R = 4, 2
    for n, m in ((7, 9), (8, 8), (9, 7), (1, 5), (5, 1), (1, 1), (17, 3)):
        x = rng.normal(0, 1, (n, D)).astype(np.float32)
        y = rng.normal(0, 1, (m, D)).astype(np.float32)
        C = _costs(x, y, "euclidean")
        assert np.isclose(k3_pair(C, n, m, lanes=lanes, R=R, W=8 * -(-m // 8)),
                          dtw_oracle(x, y), rtol=1e-12), (n, m)
        pw = max(2, abs(n - m))
        assert np.isclose(k7_pair(C, n, m, pw, pw + 3, lanes=lanes, R=R),
                          dtw_oracle(x, y, band=2, band_mode="widen"), rtol=1e-12), (n, m)


def k6_warp(pairs, *, G, R, S, warp=32):
    """One warp of K6's walk: ``pairs`` (at most warp/G) of (C, la, lb, pw),
    C the [la, lb] costs or None for a group without a live pair.  Every
    lane of the warp is modelled: the shuffle moves lane l-1's bottom cell
    to lane l within a group of G lanes (its lane 0 keeps its own), the
    group's lane 0 reads its boundary row of S absolute columns and its
    lane G-1 writes it; each pass steps the warp to the longest window of
    its groups, and the warp's passes run to its longest pair.  Returns
    each pair's distance (+inf for None)."""
    groups = warp // G
    assert len(pairs) <= groups
    pairs = list(pairs) + [None] * (groups - len(pairs))
    passes = [0 if q is None else -(-q[1] // (G * R)) for q in pairs]
    bnd = np.full((groups, S), GARBAGE)
    out = [INF] * groups
    for qi in range(max(passes)):
        i0 = qi * G * R
        win, reads, writes, lo, hi = [], [], [], np.ones((warp, R), int), np.zeros((warp, R), int)
        for g, q in enumerate(pairs):
            act = qi < passes[g]
            if not act:
                win.append((1, 0))
                reads.append((1, 0))
                writes.append((1, 0))
                continue
            _, la, lb, pw = q
            rows = i0 + np.arange(G)[:, None] * R + np.arange(R)[None, :]
            live = rows < la
            lo[g * G:(g + 1) * G] = np.where(live, np.maximum(rows - pw, 0), 1)
            hi[g * G:(g + 1) * G] = np.where(live, np.minimum(rows + pw, lb - 1), 0)
            i_last = min(i0 + G * R - 1, la - 1)
            win.append((max(0, i0 - pw), min(lb - 1, i_last + pw)))
            reads.append((max(0, i0 - 1 - pw), min(lb - 1, i0 - 1 + pw)) if i0 > 0 else (1, 0))
            ib = i0 + G * R - 1
            writes.append((max(0, ib - pw), min(lb - 1, ib + pw)) if i0 + G * R < la else (1, 0))

        def read(g, j):
            if not reads[g][0] <= j <= reads[g][1]:
                return INF
            assert 0 <= j < S
            return bnd[g, j]

        steps = max(c_hi - c_lo + G for c_lo, c_hi in win)
        left = np.full((warp, R), INF)
        bottom = np.full(warp, INF)
        up_prev = np.full(warp, INF)
        for g in range(groups):
            up_prev[g * G] = 0.0 if i0 == 0 else read(g, win[g][0] - 1)
        for t in range(steps):
            gl = np.arange(warp) % G
            shuffled = np.where(gl > 0, np.roll(bottom, 1), bottom)
            new_bottom = bottom.copy()
            for lane in range(warp):
                g, c = divmod(lane, G)
                c_lo, c_hi = win[g]
                j = c_lo + t - c
                on = c_lo <= j <= c_hi
                up = shuffled[lane]
                if c == 0:
                    up = read(g, j) if on else INF
                diag, up_prev[lane] = up_prev[lane], up
                if not on:
                    continue
                C = pairs[g][0]
                for k in range(R):
                    i = i0 + c * R + k
                    cost = C[i, j] if lo[lane, k] <= j <= hi[lane, k] else INF
                    v = cost + min(diag, up, left[lane, k])
                    diag, left[lane, k], up = left[lane, k], v, v
                new_bottom[lane] = up
                if c == G - 1 and writes[g][0] <= j <= writes[g][1]:
                    assert 0 <= j < S
                    bnd[g, j] = up
            bottom = new_bottom
        for g, q in enumerate(pairs):
            if qi == passes[g] - 1:
                corner = q[1] - 1 - i0
                out[g] = left[g * G + corner // R, corner % R]
    return out


def k6_walk(a, b, la, lb, *, band, auto_widen=True, metric="euclidean", G=8, R=2):
    """[B] unnormalized distances of gathered pairs in K6's walk order: 32/G
    consecutive pairs a warp, the rows and band contracts +inf."""
    Ra, S = a.shape[1], b.shape[1]
    groups = 32 // G
    out = np.full(len(la), INF)
    for w0 in range(0, len(la), groups):
        pairs = []
        for p in range(w0, min(w0 + groups, len(la))):
            n, m = int(la[p]), int(lb[p])
            diff = abs(n - m)
            pw = S if band is None else (diff if auto_widen and diff > band else band)
            live = 1 <= n <= Ra and 1 <= m <= S and diff <= pw
            pairs.append((_costs(a[p, :n], b[p, :m], metric), n, m, pw) if live else None)
        out[w0:w0 + len(pairs)] = k6_warp(pairs, G=G, R=R, S=S)[:len(pairs)]
    return out


def _k6_pairs(seed, B=12, Ra=40, S=48):
    """Gathered pairs with la, lb and pw all different within each warp:
    shorter side first, la up to Ra, one pair past it (la > Ra: +inf), and
    lengths 1 on either side."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, Ra, D)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    lb = rng.integers(2, S + 1, B)
    la = np.minimum(rng.integers(1, Ra + 1, B), lb)
    la[0], lb[0] = 1, 30                      # length 1, then a wide widen band
    la[1], lb[1] = 1, 1
    la[2], lb[2] = 17, 1 + 17                 # near-diagonal
    la[3], lb[3] = Ra + 3, S                  # past the rows: +inf
    return a, b, la.astype(np.int32), lb.astype(np.int32)


K6_MODES = {"unbanded": dict(band=None), "widen": dict(band=3),
            "hard": dict(band=9, auto_widen=False)}
_K6_REF: dict = {}


def _k6_references(mode):
    """(JAX in interpret mode, twin, oracle) for _k6_pairs(71) in ``mode``,
    computed once."""
    if mode not in _K6_REF:
        a, b, la, lb = _k6_pairs(71)
        kw = K6_MODES[mode]
        jx = np.asarray(jp.dtw_batch_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), interpret=True,
            normalize="none", **kw))
        twin = tk.dtw_batch_pallas_ref(*[torch.from_numpy(x) for x in (a, b, la, lb)],
                                       **kw).numpy()
        ora = np.full(len(la), INF)
        for p in range(len(la)):
            if la[p] <= a.shape[1]:
                ora[p] = dtw_oracle(a[p, :la[p]], b[p, :lb[p]], band=kw["band"],
                                    auto_widen=kw.get("auto_widen", True))
        _K6_REF[mode] = jx, twin, ora
    return _K6_REF[mode]


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("G", [32, 16, 8, 4])
@pytest.mark.parametrize("mode", list(K6_MODES))
def test_k6_walk_matches_jax_oracle_and_twin(mode, G, R):
    # 12 pairs (up to 8 a warp) of different la, lb and pw, lengths 1 on
    # either side, la > Ra on one (+inf); the hard band 9 cuts the 6 pairs
    # whose corner lies outside it and keeps one at |la - lb| = 9.
    a, b, la, lb = _k6_pairs(71)
    got = k6_walk(a, b, la, lb, G=G, R=R, **K6_MODES[mode])
    jx, twin, ora = _k6_references(mode)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(twin))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(jx))
    assert np.isinf(got[3]) and np.isfinite(got).sum() == (5 if mode == "hard" else 11)
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], twin[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[fin], ora[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[fin], jx[fin], rtol=1e-4, atol=1e-4)
    if mode == "hard":
        cut = np.abs(la.astype(int) - lb) > 9
        assert cut.any() and np.isinf(got[cut]).all()


@pytest.mark.parametrize("G,R", [(32, 1), (16, 2), (8, 4), (4, 2)])
def test_k6_walk_at_pass_boundaries(G, R):
    # la at G*R - 1, G*R and G*R + 1 (one pass, one exactly, two), a pair of
    # length 1 on either side, in one warp with pairs of other lengths: each
    # the oracle's distance, unbanded and widen (pw up to S).
    rng = np.random.default_rng(72 + G + R)
    n = G * R
    S = n + 6
    shapes = [(n - 1, n + 4), (n, n), (n + 1, n + 6), (1, 5), (5, 5), (1, 1), (n + 1, n + 1),
              (3, n + 2)]
    B = len(shapes)
    a = rng.normal(0, 1, (B, n + 1, D)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    la = np.array([x for x, _ in shapes], np.int32)
    lb = np.array([y for _, y in shapes], np.int32)
    for kw in (dict(band=None), dict(band=2)):
        got = k6_walk(a, b, la, lb, G=G, R=R, **kw)
        twin = tk.dtw_batch_pallas_ref(*[torch.from_numpy(x) for x in (a, b, la, lb)],
                                       **kw).numpy()
        np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-5)
        for p in range(B):
            want = dtw_oracle(a[p, :la[p]], b[p, :lb[p]], band=kw["band"])
            assert np.isclose(got[p], want, rtol=1e-5), (kw, p)
