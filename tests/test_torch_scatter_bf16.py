"""PyTorch port: the rounding of the bf16 K2 slab's cotangent scatter
(``cfg.pair_dtype="bfloat16"``), pinned on the CPU.

``pair_kernels.slab_to_slots_bf16_plain`` is held bit for bit against a
numpy model of the JAX package's rounding (its K2 VJP returns each bucket's
f32 slot sums as bf16, and autograd adds the buckets' bf16 cotangents in
bf16, last bucket first): per slot group its readers walked in ascending
order, each bucket's f32 sum rounded to bf16, the buckets added in bf16,
last first.  The inputs are f64 values cast to f32, on a synthetic CSR
inverse over 8 buckets whose lists have 0, 1, 31, 32, 33 and 100 readers
(every bucket boundary crossed, a bucket without readers inside a list, a
group read only by the last bucket), and on a small sparse scene's own
inverse.  The card kernel is held to the plain version on the same lists
by ``tests/test_torch_cuda.py``; this file imports nothing of JAX, so that
one can import :func:`synthetic_csr` from it."""

import numpy as np
import pytest
import torch

from softbody_tpu_torch.ops import pair_kernels as pk

N_BUCKETS = 8
BUCKET_POSITIONS = 96          # group entries per synthetic bucket
# (list length, buckets its readers come from): the edge lists
EDGE_LISTS = ((0, ()), (1, (3,)), (31, tuple(range(8))), (32, (1, 2, 5, 6)),
              (33, (7,)), (100, tuple(range(8))), (0, ()), (17, (0, 4, 7)),
              (64, (2, 3, 4)))


def synthetic_csr(group, seed=0, fields=15):
    """A CSR inverse over ``N_BUCKETS`` buckets of ``BUCKET_POSITIONS``
    group entries each, one slot group per :data:`EDGE_LISTS` entry, and a
    (fields, n_entries) float32 buffer of f64 normals: (buf, slab_ptr,
    slab_idx, bstart, n_slots, group), int32 indices, CPU tensors.  Every
    list is ascending and bucket-major, as ``slab_inverse`` builds it;
    entries no list names are the padding group's readers, left out."""
    rng = np.random.default_rng(seed)
    pools = [list(b * BUCKET_POSITIONS + rng.permutation(BUCKET_POSITIONS))
             for b in range(N_BUCKETS)]
    lists = []
    for length, buckets in EDGE_LISTS:
        picks = [pools[buckets[i % len(buckets)]].pop() for i in range(length)]
        lists.append(sorted(int(p) for p in picks))
    ptr = np.cumsum([0] + [len(x) for x in lists])
    idx = np.concatenate([np.asarray(x, np.int64) for x in lists])
    n_pos = N_BUCKETS * BUCKET_POSITIONS
    buf = rng.normal(size=(fields, n_pos * group)).astype(np.float32)
    bstart = np.arange(N_BUCKETS) * BUCKET_POSITIONS
    return (torch.from_numpy(buf), torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(bstart.astype(np.int32)), len(lists) * group, group)


def bf16_bits(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def jax_rounding(buf, slab_ptr, slab_idx, bstart, n_slots, group):
    """The numpy model: (k, n_slots) float32 holding bf16 values."""
    buf, ptr, idx = buf.numpy(), slab_ptr.numpy(), slab_idx.numpy()
    starts = list(bstart.numpy()) + [np.iinfo(np.int64).max]
    k = buf.shape[0]
    out = np.zeros((k, n_slots), np.float32)
    for g in range(n_slots // group):
        readers = idx[ptr[g]:ptr[g + 1]]
        tot = np.zeros((k, group), np.float32)
        for b in reversed(range(len(starts) - 1)):
            acc = np.zeros((k, group), np.float32)
            for p in readers[(readers >= starts[b]) & (readers < starts[b + 1])]:
                acc = acc + buf[:, p * group:(p + 1) * group]       # f32, in order
            tot = bf16_bits(tot + bf16_bits(acc))
        out[:, g * group:(g + 1) * group] = tot
    return out


def _held(args):
    got = pk.slab_to_slots_bf16(*args)           # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (args[0].shape[0], args[4])
    want = jax_rounding(*args)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))
    return got, want


@pytest.mark.parametrize("group", [4, 8, 16])
def test_plain_rounds_as_jax_on_edge_lists(group):
    args = synthetic_csr(group)
    got, want = _held(args)
    ptr = args[1].numpy()
    for g, (length, _) in enumerate(EDGE_LISTS):
        assert ptr[g + 1] - ptr[g] == length
        cols = slice(g * group, (g + 1) * group)
        if length == 0:                           # no readers: exact zeros
            assert not np.any(want[:, cols].view(np.uint32))
    # the rounding per bucket shows: one rounding of the whole f32 sum differs
    whole = bf16_bits(pk.slab_to_slots_plain(*args[:3], args[4], group).numpy())
    assert np.any(whole != want)


def test_plain_rounds_as_jax_on_a_scene():
    """A small sparse scene's own CSR inverse and bucket starts."""
    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
    from softbody_tpu_torch.sim.sparse import build_sparse_scene

    pts, out_num = inflatable_sphere(n_outer=80)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32", backend="pallas")
    scene, _ = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    sb = scene.blocked
    assert len(sb.buckets) > 1
    buf = torch.from_numpy(np.random.default_rng(3).normal(
        size=(15, pk.n_entries(sb))).astype(np.float32))
    _held((buf, sb.slab_ptr, sb.slab_idx, sb.bucket_starts, sb.n_slots, sb.group))
