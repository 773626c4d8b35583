"""D assembled on the card (audio_pattern_discovery_tpu_torch/ops/dtw_scatter.py)
against the host scatter it replaces on the CUDA path: the plain twins
(what the wrappers run on CPU tensors) bitwise the native
``scatter_block_direct`` and the NumPy chain, the tiled scheduler's device
path (its gate held on, through the twins) bitwise the host path, and the
gate's choice of path.  No tolerance anywhere: both paths divide in IEEE
fp32 in the same order and copy otherwise."""

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


def _inputs(K, ti, pairs, seed):
    rng = np.random.default_rng(seed)
    nT = -(-K // ti)
    blocks = rng.uniform(0, 50, (len(pairs), ti, ti)).astype(np.float32)
    lens = np.ones(nT * ti, np.int32)
    lens[:K] = np.sort(rng.integers(2, 200, K))
    perm = rng.permutation(K).astype(np.int64)
    return blocks, lens, perm


def _numpy_chain(blocks, lens, perm, pairs, K, ti, norm):
    """The scheduler's NumPy scatter (its path without the native library)."""
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


def _native(blocks, lens, perm, pairs, K, ti, norm):
    D = np.full((K, K), SENTINEL, np.float32)
    ls = lens.astype(np.float32)
    for blk, (I, J) in zip(blocks, pairs):
        r0, c0 = I * ti, J * ti
        nr, nc = min(ti, K - r0), min(ti, K - c0)
        native.scatter_block_direct(
            np.ascontiguousarray(blk), nr, nc, ls[r0 : r0 + nr] if norm else None,
            ls[c0 : c0 + nc] if norm else None, perm[r0 : r0 + nr], perm[c0 : c0 + nc], D, I == J,
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
    if native.available():
        np.testing.assert_array_equal(
            got.view(np.int32), _native(blocks, lens, perm, pairs, K, ti, norm).view(np.int32))
    if case == "all_tile_pairs":
        assert (got != SENTINEL).all()
        np.testing.assert_array_equal(got, got.T)
        np.testing.assert_array_equal(np.diag(got), 0.0)


def _case(seed, K=37, L=32, d=3, lo=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(lo, L + 1, K).astype(np.int32)
    return feats, lens


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
    kw = dict(ti=8, chunk_programs=3, device="cpu")
    s_host, s_dev = {}, {}
    host = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=s_host, **kw)
    monkeypatch.setattr(tps, "_device_assembly", lambda *a: True)
    dev = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=s_dev, **kw)
    assert s_dev["route"] == route
    np.testing.assert_array_equal(dev.view(np.int32), host.view(np.int32))
    assert dev.dtype == np.float32 and dev.flags["C_CONTIGUOUS"]
    assert s_host["device_scatter_blocks"] == 0
    assert s_dev["device_scatter_blocks"] == s_dev["tile_programs"] == 5 * 6 // 2
    assert not s_dev["native_scatter"]


CUDA = torch.device("cuda", 0)


@pytest.mark.parametrize(
    "devs,K,known,block_dir,big,want",
    [
        ([CUDA], 100, None, None, False, True),
        ([CUDA] * 4, 100, None, None, False, True),
        ([torch.device("cpu")], 100, None, None, False, False),
        ([CUDA, torch.device("cuda", 1)], 100, None, None, False, False),
        ([CUDA], 100, (50, np.zeros((50, 50), np.float32)), None, False, False),
        ([CUDA], 100, None, "blocks", False, False),
        ([CUDA], 100, None, None, True, False),
    ],
    ids=["one_card", "one_card_listed", "cpu", "two_cards", "known", "block_dir", "past_2GiB"],
)
def test_gate(monkeypatch, devs, K, known, block_dir, big, want):
    if big:
        monkeypatch.setattr(tps, "_DIRECT_SCATTER_BYTES", K * K * 4 - 1)
    assert tps._device_assembly(devs, K, known, block_dir) is want


@pytest.mark.parametrize("job", ["plain", "known", "block_dir", "past_2GiB"])
def test_gate_sends_jobs_to_host_path(monkeypatch, tmp_path, job):
    # The gate's own rule applied as if the CPU were one card: a plain job
    # takes the device path (through the twins), the others the host path.
    feats, lens = _case(50, K=21)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    kw: dict = dict(ti=8, device="cpu")
    if job == "known":
        full = tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
        kw["known"] = (15, full[:15, :15].copy())
    elif job == "past_2GiB":
        monkeypatch.setattr(tps, "_DIRECT_SCATTER_BYTES", 0)
    want = tps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    gate = tps._device_assembly
    monkeypatch.setattr(tps, "_device_assembly",
                        lambda devs, *a: gate([CUDA] * len(devs), *a))
    if job == "block_dir":
        kw["block_dir"] = tmp_path / "blocks"
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, stats=stats, **kw)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    n_tile_pairs = 3 * 4 // 2
    assert stats["device_scatter_blocks"] == (n_tile_pairs if job == "plain" else 0)


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
