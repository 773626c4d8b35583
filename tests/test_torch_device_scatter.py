"""D assembled on the device (audio_pattern_discovery_tpu_torch/ops/dtw_scatter.py),
the one way the tiled scheduler builds D, against the host scatter of the
reference: the plain twins (what the wrappers run on CPU tensors) bitwise
the NumPy chain and the native direct block scatter, and the
scheduler's D bitwise that chain over the blocks it scattered, for every
route and every kind of job (``known=``, ``block_dir`` written, resumed and
written by an earlier version, a device list, the un-permute in row
panels).  No tolerance anywhere: both sides divide in IEEE fp32 in the same
order and copy otherwise."""

import ctypes
import functools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch import native
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops import dtw_scatter as ds
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

torch.set_num_threads(1)

# (K, ti, the chunk's tile-pairs): tiles of 8, the last tile 5 rows short.
CHUNKS = {
    "diagonal": (13, 8, [(0, 0)]),
    "off_diagonal": (16, 8, [(0, 1)]),
    "tail_tiles": (13, 8, [(1, 1), (0, 1), (1, 0)]),
    "padded_repeats": (13, 8, [(0, 1), (1, 1), (1, 1), (1, 1)]),
    "all_tile_pairs": (29, 8, [(i, j) for i in range(4) for j in range(i, 4)]),
}
SENTINEL = -1.0
# A diag job's blocks as an earlier version of the scheduler (its host
# scatter) wrote them under block_dir, with the D it returned.
PARENT_BLOCKS = Path(__file__).parent / "golden" / "tiled_block_dir"


def _inputs(K, ti, pairs, seed):
    rng = np.random.default_rng(seed)
    nT = -(-K // ti)
    blocks = rng.uniform(0, 50, (len(pairs), ti, ti)).astype(np.float32)
    lens = np.ones(nT * ti, np.int32)
    lens[:K] = np.sort(rng.integers(2, 200, K))
    perm = rng.permutation(K).astype(np.int64)
    return blocks, lens, perm


def _numpy_chain(blocks, lens, perm, pairs, K, ti, norm, D=None):
    """The host scatter in NumPy, into D (a sentinel-filled one by default)."""
    if D is None:
        D = np.full((K, K), SENTINEL, np.float32)
    ls = lens.astype(np.float32)
    for blk, (I, J) in zip(blocks, pairs):
        r0, c0 = I * ti, J * ti
        nr, nc = min(ti, K - r0), min(ti, K - c0)
        b = blk[:nr, :nc] / (ls[r0 : r0 + nr, None] + ls[None, c0 : c0 + nc]) if norm else blk[:nr, :nc]
        if I == J:
            b = np.triu(b, k=1)
            b = b + b.T
        r, c = perm[r0 : r0 + nr], perm[c0 : c0 + nc]
        D[np.ix_(r, c)] = b
        if I != J:
            D[np.ix_(c, r)] = b.T
    return D


def _native(lib, blocks, lens, perm, pairs, K, ti, norm):
    """The reference's native direct block scatter (the shared
    ``native/apd_native.cc``), called block by block."""
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    D = np.full((K, K), SENTINEL, np.float32)
    ls = lens.astype(np.float32)
    for blk, (I, J) in zip(blocks, pairs):
        r0, c0 = I * ti, J * ti
        nr, nc = min(ti, K - r0), min(ti, K - c0)
        blk = np.ascontiguousarray(blk)
        lr = ls[r0 : r0 + nr].ctypes.data_as(fp) if norm else None
        lc = ls[c0 : c0 + nc].ctypes.data_as(fp) if norm else None
        pr, pc = perm[r0 : r0 + nr], perm[c0 : c0 + nc]
        lib.apd_scatter_block_direct(
            blk.ctypes.data_as(fp), ctypes.c_int(ti), ctypes.c_int(nr), ctypes.c_int(nc), lr, lc,
            pr.ctypes.data_as(ip), pc.ctypes.data_as(ip), D.ctypes.data_as(fp),
            ctypes.c_int64(K), ctypes.c_int(int(I == J)),
        )
    return D


def _twins(blocks, lens, perm, pairs, K, norm):
    out = torch.full((K, K), SENTINEL)
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    ds.scatter_tile_blocks(torch.from_numpy(blocks), ii, jj, torch.from_numpy(lens),
                           torch.from_numpy(perm), out, normalize=norm)
    ds.unpermute_columns(out, torch.from_numpy(np.argsort(perm)))
    return out.numpy()


@pytest.mark.parametrize("norm", [False, True], ids=["none", "path_len"])
@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_twins_bitwise_native_and_numpy(case, norm):
    K, ti, pairs = CHUNKS[case]
    blocks, lens, perm = _inputs(K, ti, pairs, seed=len(case) + norm)
    # A padded repeat carries its tile-pair's block again.
    for u in range(1, len(pairs)):
        if pairs[u] == pairs[u - 1]:
            blocks[u] = blocks[u - 1]
    got = _twins(blocks, lens, perm, pairs, K, norm)
    want = _numpy_chain(blocks, lens, perm, pairs, K, ti, norm)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    lib = native.get_lib()
    if lib is not None:
        np.testing.assert_array_equal(
            got.view(np.int32), _native(lib, blocks, lens, perm, pairs, K, ti, norm).view(np.int32))
    if case == "all_tile_pairs":
        assert (got != SENTINEL).all()
        np.testing.assert_array_equal(got, got.T)
        np.testing.assert_array_equal(np.diag(got), 0.0)


def _case(seed, K=37, L=32, d=3, lo=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(lo, L + 1, K).astype(np.int32)
    return feats, lens


def _recording(monkeypatch) -> list:
    """Record every chunk the scheduler scatters: (blocks, tile-pairs,
    lengths, perm, normalize), each as a host copy."""
    calls: list = []
    real = tps.scatter_tile_blocks

    def keep(blocks, ii, jj, lengths, perm, out, *, normalize):
        calls.append((blocks.cpu().numpy().copy(), list(zip(ii.tolist(), jj.tolist())),
                      lengths.cpu().numpy(), perm.cpu().numpy(), normalize))
        real(blocks, ii, jj, lengths, perm, out, normalize=normalize)

    monkeypatch.setattr(tps, "scatter_tile_blocks", keep)
    return calls


def _replay(calls, K, ti, D=None):
    """The NumPy chain over the recorded chunks, in their order."""
    for blocks, pairs, lens, perm, norm in calls:
        D = _numpy_chain(blocks, lens, perm, pairs, K, ti, norm, D)
    return D


def _launches(monkeypatch, name) -> list:
    # The kernel's name enters the block keys, so the wrapper keeps it.
    real, calls = getattr(tps, name), []

    @functools.wraps(real)
    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tps, name, counting)
    return calls


@pytest.mark.parametrize(
    "route,cfg,L",
    [
        ("diag", DTWConfig(band=4, band_mode="diag", normalize="path_len"), 32),
        ("diag", DTWConfig(band=4, band_mode="diag", normalize="none", metric="cosine"), 32),
        ("tile", DTWConfig(band=None, normalize="path_len"), 32),
        ("full", DTWConfig(band=None, normalize="path_len"), 300),
        ("widen", DTWConfig(band=4, band_mode="widen", normalize="path_len"), 32),
    ],
)
def test_device_path_bitwise_host_path(monkeypatch, route, cfg, L):
    # K = 37 is no multiple of ti = 8; chunks of 3 pad their tails.
    feats, lens = _case(40 + L, L=L)
    K = len(lens)
    calls = _recording(monkeypatch)
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, chunk_programs=3, device="cpu",
                                        stats=stats)
    assert stats["route"] == route
    want = _replay(calls, K, 8)
    assert (want != SENTINEL).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    assert len(calls) == stats["blocks"]
    assert stats["device_scatter_blocks"] == stats["tile_programs"] == 5 * 6 // 2


@pytest.mark.parametrize("job", ["plain", "known", "block_dir", "past_2GiB"])
def test_gate_sends_jobs_to_host_path(monkeypatch, tmp_path, job):
    # Every kind of job assembles D through the one path: D bitwise a plain
    # job's (under known=, whose boundary tile recomputes old pairs in other
    # classes, the host rule's over the same blocks), and every tile-pair it
    # computes scattered.
    feats, lens = _case(50, K=21)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    kw: dict = dict(ti=8, device="cpu")
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    if job == "known":
        kw["known"] = (15, want[:15, :15].copy())
    elif job == "block_dir":
        kw["block_dir"] = tmp_path / "blocks"
    elif job == "past_2GiB":
        # The un-permute in panels of one row.
        monkeypatch.setattr(ds, "_PANEL_BYTES", 4)
    calls = _recording(monkeypatch)
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=stats, **kw)
    if job == "known":
        host = np.zeros_like(want)
        host[:15, :15] = want[:15, :15]
        want = _replay(calls, len(lens), 8, host)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    n_tile_pairs = 3 * 4 // 2 - (job == "known")
    assert stats["device_scatter_blocks"] == stats["tile_programs"] == n_tile_pairs
    if job == "block_dir":
        assert len(list((tmp_path / "blocks").glob("*.npz"))) == stats["blocks"]


@pytest.mark.parametrize("k_old,rows", [(1, None), (12, None), (16, None), (16, 6)],
                         ids=["one", "mid_tile", "tile_boundary", "row_panels"])
def test_known_seeds_d_like_the_host_rule(monkeypatch, k_old, rows):
    # The host rule: D[:k_old, :k_old] = D_old, then every chunk's blocks
    # over it.  D_old is arbitrary, so the entries the boundary tile
    # recomputes show that the chunks overwrite the seed; with rows, the
    # seed goes up in panels of that many rows, the last one short.
    if rows is not None:
        monkeypatch.setattr(ds, "_PANEL_BYTES", rows * 4 * k_old)
    feats, lens = _case(51, K=21)
    K = len(lens)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    rng = np.random.default_rng(k_old)
    D_old = rng.uniform(0, 9, (k_old, k_old)).astype(np.float32)
    calls = _recording(monkeypatch)
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, device="cpu", stats=stats,
                                        known=(k_old, D_old))
    host = np.zeros((K, K), np.float32)
    host[:k_old, :k_old] = D_old
    want = _replay(calls, K, stats["ti"], host)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize(
    "cfg,kernel",
    [(DTWConfig(band=3, band_mode="diag", normalize="path_len"), "dtw_tile_lane_diag_pairs"),
     (DTWConfig(band=None, normalize="path_len"), "dtw_tile_pairs")],
    ids=["diag", "tile"],
)
def test_block_dir_resumed_whole(monkeypatch, tmp_path, cfg, kernel):
    feats, lens = _case(52, K=21)
    kw = dict(ti=8, chunk_programs=2, device="cpu", block_dir=tmp_path)
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, device="cpu")
    first = tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    launches = _launches(monkeypatch, kernel)
    stats: dict = {}
    again = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=stats, **kw)
    assert launches == [] and stats["blocks_resumed"] == stats["blocks"] > 1
    assert stats["device_scatter_blocks"] == stats["tile_programs"]
    np.testing.assert_array_equal(first.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(again.view(np.int32), want.view(np.int32))


def test_block_dir_of_an_earlier_version_resumes(monkeypatch, tmp_path):
    # PARENT_BLOCKS holds every chunk of this job: nothing is launched, and
    # D is bitwise the D that version returned.
    for f in PARENT_BLOCKS.glob("*.npz"):
        shutil.copy(f, tmp_path)
    feats, lens = _case(60, K=21)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    launches = _launches(monkeypatch, "dtw_tile_lane_diag_pairs")
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4, chunk_programs=8, device="cpu",
                                        block_dir=tmp_path, stats=stats)
    assert launches == [] and stats["blocks_resumed"] == stats["blocks"] == 3
    want = np.load(PARENT_BLOCKS / "D.npy")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in PARENT_BLOCKS.glob("*.npz"))


@pytest.mark.parametrize("n", [2, 3])
def test_device_list_bitwise_one_device(n):
    feats, lens = _case(53, K=29)
    cfg = DTWConfig(band=4, band_mode="widen", normalize="path_len")
    kw = dict(ti=8, chunk_programs=2)
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, device="cpu", **kw)
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, devices=["cpu"] * n, stats=stats, **kw)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert len(stats["device_blocks"]) == n and min(stats["device_blocks"]) > 0
    assert sum(stats["device_blocks"]) == stats["blocks"]
    assert stats["device_scatter_blocks"] == stats["tile_programs"]


def test_known_with_block_dir(monkeypatch, tmp_path):
    # An update that persists its chunks, then the same update resumed:
    # both the update's D without block_dir.
    feats, lens = _case(54, K=21)
    cfg = DTWConfig(band=None, normalize="path_len")
    full = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, device="cpu")
    kw = dict(ti=8, chunk_programs=1, device="cpu", known=(10, full[:10, :10].copy()))
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    launches = _launches(monkeypatch, "dtw_tile_pairs")
    first, again = {}, {}
    D1 = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=first, block_dir=tmp_path, **kw)
    n1 = len(launches)
    D2 = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=again, block_dir=tmp_path, **kw)
    assert first["blocks_resumed"] == 0 and n1 == first["blocks"] == first["tile_programs"] == 5
    assert len(launches) == n1 and again["blocks_resumed"] == again["blocks"] == 5
    np.testing.assert_array_equal(D1.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(D2.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("save_fails", [False, True], ids=["resumed", "save_error"])
def test_a_failed_job_persists_what_it_computed(monkeypatch, tmp_path, save_fails):
    # The third chunk's launch fails with no retry: the two chunks computed
    # before it persist and the rerun resumes them.  A file that cannot be
    # written is removed, and its error never replaces the launch's.
    feats, lens = _case(55, K=21)
    cfg = DTWConfig(band=None, normalize="path_len")
    kw = dict(ti=8, chunk_programs=1, device="cpu", block_dir=tmp_path, max_retries=0)
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, device="cpu")
    real, launched = tps.dtw_tile_pairs, []

    @functools.wraps(real)
    def failing(*args, **kwargs):
        if len(launched) == 2:
            raise RuntimeError("launch failure")
        launched.append(1)
        return real(*args, **kwargs)

    def partial_write(path, **arrays):
        Path(path).write_bytes(b"partial")
        raise OSError("no space left on device")

    monkeypatch.setattr(tps, "dtw_tile_pairs", failing)
    savez = np.savez
    if save_fails:
        monkeypatch.setattr(np, "savez", partial_write)
    with pytest.raises(RuntimeError, match="launch failure"):
        tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    monkeypatch.setattr(np, "savez", savez)
    assert len(list(tmp_path.glob("*.npz"))) == (0 if save_fails else 2)
    monkeypatch.setattr(tps, "dtw_tile_pairs", real)
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=stats, **kw)
    assert stats["blocks_resumed"] == (0 if save_fails else 2)
    assert stats["blocks"] == stats["tile_programs"] == 6
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrappers_refuse_bad_inputs():
    blocks = torch.zeros((1, 8, 8))
    idx = torch.zeros(1, dtype=torch.int32)
    lens, perm, out = torch.ones(16, dtype=torch.int32), torch.arange(13), torch.zeros((13, 13))
    ds.scatter_tile_blocks(blocks, idx, idx, lens, perm, out, normalize=True)
    bad = [
        dict(blocks=blocks.double()),
        dict(blocks=torch.zeros((1, 8, 4))),
        dict(ti_idx=idx.long()),
        dict(lengths=torch.ones(13, dtype=torch.int32)),
        dict(perm=perm.int()),
        dict(out=torch.zeros((13, 12))),
        dict(out=torch.zeros((26, 13))[::2]),
        dict(blocks=blocks.to("meta")),
    ]
    for over in bad:
        args = dict(blocks=blocks, ti_idx=idx, tj_idx=idx, lengths=lens, perm=perm, out=out)
        args.update(over)
        with pytest.raises(ValueError):
            ds.scatter_tile_blocks(**args, normalize=True)
    with pytest.raises(ValueError):
        ds.unpermute_columns(out, perm.int())
    with pytest.raises(ValueError):
        ds.unpermute_columns(out, perm[:12])
