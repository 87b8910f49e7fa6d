"""Tile planner of the two convolution kernels, B (``csrc/conv2d.cu``) and N
(``csrc/conv3d.cu``).

From a layer's shape it decides the block tile (``bm`` output cells by
``bn`` output channels), the warp tile (32x32, or on the bf16 route the
wide 64 x bn/2 for layers with many output cells: ``warp_m`` 64) and how
the K range (taps x input channels) is cut into splits; the kernels take
the plan as arguments, check it and make no decision of their own.

The aim is several blocks on each of the H100's 132 SMs on every layer,
so that the warps of one block hide the latency of another's: the largest
tile that still gives ``FILL_BLOCKS[route]`` blocks, else the smallest
tile and a split-K up to that many blocks, with at least ``MIN_CHUNKS``
chunks a split, or one chunk where that is what one wave (``WAVE`` blocks)
takes. A 3xTF32 chunk carries six times the MMAs of a bf16 one and needs
half the blocks. A wide tile (four warps of 64 x bn/2) goes to a layer
that has ``WIDE_MIN_TILES`` of them, two waves, without a split.
``python -m fluidnet_cxx_tpu_torch.conv_plan_sweep`` times the forwards
under other settings; on an H100 (PERF.md §6) a fill of one block an
SM made the forwards 1.2-1.8x slower, and the wide tile took p4's concat
from 0.45 to 0.37 ms and slowed p8's, which has 32 such tiles, from 0.067
to 0.084 ms.

A split covers whole chunks: K offsets that are multiples of the route's
chunk, which lies inside one tap and one input because every input's
channel count is a multiple of it (the chunk is one pipeline stage: 32
channels on the tensor-core routes, 16 on the float32 SIMT route). With
more than one split each writes a float32 partial tile to a workspace and
one reduce launch adds them in the order 0..S-1, then the bias, then the
ReLU: repeats are bit-equal and nothing is summed with atomics.
"""
import ctypes
import functools
from dataclasses import dataclass

WAVE = 128           # one block on each of an H100's 132 SMs, within 3%
FILL_BLOCKS = {"bf16": 4 * WAVE, "tf32x3": 2 * WAVE, "simt": 4 * WAVE}
MIN_CHUNKS = 2       # chunks a split at least
MAX_SPLITS = 64      # csrc/conv_mma.cuh::kMaxSplits
MAX_TILE = 8192      # bm * bn: at most 8 warps of 32x32 outputs a block
WIDE_MIN_TILES = 256  # wide 128-row tiles where they make two waves
WIDE_BNS = (64, 96, 128)
BMS = (128, 64, 32)  # block rows, largest first
BNS = (128, 96, 64)  # block columns for co above 128
CHUNK = {"bf16": 32, "tf32x3": 32, "simt": 16}


@dataclass(frozen=True)
class ConvPlan:
    """``bounds[s]:bounds[s+1]`` is split s's K range (elements)."""
    bm: int
    bn: int
    warp_m: int
    bounds: tuple
    chunk: int
    tiles: int

    @property
    def splits(self) -> int:
        return len(self.bounds) - 1

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @functools.cached_property
    def c_bounds(self):
        """``bounds`` as a C int array for the kernels' entries."""
        return (ctypes.c_int * len(self.bounds))(*self.bounds)


def _block_cols(co: int) -> int:
    if co <= 128:
        return -(-co // 32) * 32
    # The fewest wasted columns; the wider tile on a tie.
    return min(BNS, key=lambda bn: (-(-co // bn) * bn - co, -bn))


@functools.lru_cache(maxsize=256)
def plan_conv(m: int, co: int, taps: int, c1: int, c2: int,
              route: str = "bf16") -> ConvPlan:
    """Plan one conv layer: ``m`` output cells, ``co`` output channels,
    ``taps`` kernel taps over channels [c1 | c2]. ``route`` is the kernel
    body ("bf16", "tf32x3" or "simt")."""
    chunk = CHUNK[route]
    if c1 < chunk or c1 % chunk or c2 % chunk:
        raise ValueError(f"the {route} conv needs input channel counts "
                         f"that are multiples of {chunk} (got {c1}, {c2})")
    n_chunks = taps * (c1 + c2) // chunk
    warp_m = 32
    if route == "simt":
        bm = bn = 64
    else:
        bn = _block_cols(co)
        fits = [b for b in BMS if b * bn <= MAX_TILE]
        bm = next((b for b in fits
                   if -(-m // b) * -(-co // bn) >= FILL_BLOCKS[route]),
                  fits[-1])
        if (route == "bf16" and bn in WIDE_BNS
                and -(-m // 128) * -(-co // bn) >= WIDE_MIN_TILES):
            bm, warp_m = 128, 64
    tiles = -(-m // bm) * -(-co // bn)
    fill = WIDE_MIN_TILES if warp_m == 64 else FILL_BLOCKS[route]
    splits = max(1, min(-(-fill // tiles), n_chunks // MIN_CHUNKS,
                        MAX_SPLITS))
    if tiles * splits < WAVE:
        splits = max(splits, min(-(-WAVE // tiles), n_chunks, MAX_SPLITS))
    bounds = tuple(s * n_chunks // splits * chunk for s in range(splits + 1))
    return ConvPlan(bm, bn, warp_m, bounds, chunk, tiles)
