"""A numpy model of the bit-parallel band kernel behind K1
(ldso_tpu_torch/csrc/distance_map.cu), held exactly against the port's
plain version, the JAX function and the Pallas kernel in interpret mode.

The kernel itself runs only on a CUDA card (tests/test_torch_cuda.py).
This model rehearses its algorithm where it cannot run, step for step:

  * one bit per cell: row y is ceil(W / 32) uint32 words, bit i of word w
    is column 32 w + i;
  * reached sets: R_0 = occupied, R_k = R_{k-1} | N_k(R_{k-1} & I), with I
    the interior cells (1 <= y <= H-2, 1 <= x <= W-2, global coordinates)
    as a per-word column mask and a per-row test, N_k the 4-neighbour
    dilation on even k and the 8-neighbour dilation on odd k; horizontal
    neighbours are shifts with the carry bit of the adjacent word;
  * two buffers: sweep k reads R_{k-1} and writes R_k, never in place;
  * bands: each block owns `band` output rows, loads them with max_k - 1
    halo rows on each side (clamped at the image) and sweeps them with no
    outside input; sweep k computes only the rows within max_k - 1 - k of
    the band, so every row it reads was written by sweep k - 1 (rows
    outside that cone keep stale values, which the model fills with
    garbage to prove that nothing reads them);
  * the first-reach record: the band's words of every R_k are kept, and
    each band cell bisects them for the least k whose set holds it (the
    sets are nested), 1000 when R_{max_k-1} does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_utils import equal

from ldso_tpu.ops.distance_map import distance_transform as jax_distance
from ldso_tpu_torch.ops.cuda_kernels import SMEM_LIMIT, distance_plan
from ldso_tpu_torch.ops.distance_map import distance_transform_ref

U32 = np.uint32
H100_SMS = 132


def _pack(bits: np.ndarray) -> np.ndarray:
    """(..., W) bool -> (..., ceil(W / 32)) uint32, bit i of word w =
    column 32 w + i."""
    W = bits.shape[-1]
    nw = (W + 31) // 32
    pad = np.zeros(bits.shape[:-1] + (nw * 32,), bool)
    pad[..., :W] = bits
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (pad.reshape(bits.shape[:-1] + (nw, 32)).astype(np.uint64)
            * weights).sum(-1).astype(U32)


def _unpack(words: np.ndarray, W: int) -> np.ndarray:
    bits = (words[..., None] >> np.arange(32, dtype=U32)) & U32(1)
    return bits.reshape(words.shape[:-1] + (-1,))[..., :W].astype(bool)


def _from_left(s):
    """Cells whose left neighbour (x - 1) is in s: shift up one bit, with
    the top bit of the word to the left carried in."""
    carry = np.zeros_like(s)
    carry[:, 1:] = s[:, :-1] >> U32(31)
    return (s << U32(1)) | carry


def _from_right(s):
    """Cells whose right neighbour (x + 1) is in s."""
    carry = np.zeros_like(s)
    carry[:, :-1] = s[:, 1:] << U32(31)
    return (s >> U32(1)) | carry


def _first_reach(hist: np.ndarray, W: int) -> np.ndarray:
    """hist: (max_k, rows, nw) band words of R_0 .. R_{max_k-1}. Per cell,
    the least k with the cell in R_k by bisection, else 1000."""
    bits = _unpack(hist, W)                               # (max_k, rows, W)
    rows, cols = np.indices(bits.shape[1:])
    a = np.zeros(bits.shape[1:], np.int64)
    b = np.full(bits.shape[1:], len(hist) - 1)
    while (a < b).any():
        m = (a + b) // 2
        in_m = bits[m, rows, cols]
        active = a < b
        b = np.where(active & in_m, m, b)
        a = np.where(active & ~in_m, m + 1, a)
    return np.where(bits[-1], b, 1000.0).astype(np.float32)


def bit_band_model(occ: np.ndarray, max_k: int, band: int,
                   seed: int = 0) -> np.ndarray:
    H, W = occ.shape
    halo = max_k - 1
    words = _pack(occ)
    nw = words.shape[1]
    cols = np.arange(nw * 32)
    col_mask = _pack((cols >= 1) & (cols <= W - 2))[None, :]  # (1, nw)
    garbage = np.random.RandomState(seed)
    out = np.empty((H, W), np.float32)
    for y0 in range(0, H, band):
        y1 = min(H, y0 + band)
        lo0, hi0 = max(0, y0 - halo), min(H, y1 + halo)
        cur = words[lo0:hi0].copy()
        # the second buffer starts as uninitialised shared memory
        nxt = garbage.randint(0, 2 ** 32, size=cur.shape, dtype=np.uint64
                              ).astype(U32)
        hist = [cur[y0 - lo0:y1 - lo0].copy()]
        for k in range(1, max_k):
            lo = max(lo0, y0 - (halo - k))
            hi = min(hi0, y1 + (halo - k))

            def sources(dy):
                """R_{k-1} & I on rows lo+dy .. hi-1+dy; 0 off the image
                or outside the loaded rows."""
                ys = np.arange(lo, hi) + dy
                ok = (ys >= 1) & (ys <= H - 2) & (ys >= lo0) & (ys < hi0)
                s = np.zeros((hi - lo, nw), U32)
                s[ok] = cur[ys[ok] - lo0] & col_mask
                return s

            up, mid, dn = sources(-1), sources(0), sources(1)
            dil = _from_left(mid) | _from_right(mid) | up | dn
            if k % 2 == 1:
                dil |= (_from_left(up) | _from_right(up)
                        | _from_left(dn) | _from_right(dn))
            old = cur[lo - lo0:hi - lo0]
            now = old | dil
            nxt[lo - lo0:hi - lo0] = now
            hist.append(now[y0 - lo:y1 - lo].copy())   # the band's rows
            cur, nxt = nxt, cur
        out[y0:y1] = _first_reach(np.stack(hist), W)
    return out


def _occupancy(shape, p, seed=11):
    return np.random.RandomState(seed).rand(*shape) < p


# widths not a multiple of 32, KITTI's half-resolution map, a map shorter
# than the 16-row band, and the smallest map with an interior cell
SHAPES = [(61, 97), (188, 620), (10, 40), (3, 5)]


@pytest.mark.parametrize("p", [0.0, 0.005, 0.1, 1.0])
@pytest.mark.parametrize("band", [1, 16, "over_h"])
@pytest.mark.parametrize("max_k", [1, 2, 18, 40])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bit_band_model_is_exact(shape, max_k, band, p):
    """atol 0 against the plain version and the JAX function."""
    band = shape[0] + 5 if band == "over_h" else band
    occ = _occupancy(shape, p)
    got = bit_band_model(occ, max_k, band)
    want = distance_transform_ref(torch.from_numpy(occ), max_k)
    equal(got, want, f"plain, band {band}")
    equal(got, jax_distance(jnp.asarray(occ), max_k), f"jax, band {band}")


@pytest.mark.parametrize("max_k", [2, 18])
def test_bit_band_model_matches_pallas(max_k):
    from ldso_tpu.ops.pallas_kernels import distance_transform_pallas
    occ = _occupancy((61, 97), 0.02, seed=4)
    equal(bit_band_model(occ, max_k, 16),
          distance_transform_pallas(jnp.asarray(occ), max_k, interpret=True))


@pytest.mark.parametrize("shape,max_k", [((240, 320), 18), ((540, 960), 18),
                                         ((1000, 1000), 40)])
def test_bit_band_model_at_the_wrappers_plan(shape, max_k):
    """The band the wrapper launches with, at the main path's map and at
    two maps the one-block byte kernel refused."""
    band, _ = distance_plan(*shape, max_k, H100_SMS)
    occ = _occupancy(shape, 0.01)
    equal(bit_band_model(occ, max_k, band),
          distance_transform_ref(torch.from_numpy(occ), max_k))


def test_distance_plan():
    """The fewest band rows that keep one block per SM; two bit buffers of
    the band plus its halo rows (and two spare words) and the band's words
    of max_k sets, within the 48 KB a block gets without opting in."""
    assert SMEM_LIMIT == 48 * 1024
    # 240 rows on 132 SMs: 2-row bands, 36 loaded rows of 10 words
    assert distance_plan(240, 320, 18, H100_SMS) == (
        2, 4 * (10 * (72 + 36) + 2))
    assert distance_plan(540, 960, 18, H100_SMS) == (
        5, 4 * (30 * (78 + 90) + 2))
    # 8-row bands would need 62,984 bytes at max_k 40
    assert distance_plan(1000, 1000, 40, H100_SMS) == (
        4, 4 * (32 * (2 * 82 + 160) + 2))
    # a map shorter than its halo: the buffers hold all 10 rows
    assert distance_plan(10, 40, 18, H100_SMS) == (
        1, 4 * (2 * (2 * 10 + 18) + 2))
    with pytest.raises(ValueError, match="shared memory"):
        distance_plan(4000, 4000, 40, H100_SMS)
