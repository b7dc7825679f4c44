"""Deterministic checkpoint→block-image layout (the paper's ext4 flattening).

The paper flattens layered container images with a *deterministic, serial*
filesystem so unchanged files produce identical blocks (§2). The analogue
for a parameter pytree:

  * tensors ordered by canonical path string (sorted, stable),
  * each tensor starts at a chunk-aligned offset (512 KiB), zero-padded —
    identical tensors at different tree positions across two models still
    produce byte-identical chunk sequences,
  * all metadata (dtype as a fixed string, shape) serialized canonically.

``shard_byte_ranges`` maps a (tensor, per-dim shard index) to the byte
ranges it occupies inside the image, which is what shard-aware demand
loading (the paper's *sparsity*) consumes.

Leaves are numpy arrays or torch tensors. A bfloat16 leaf (a torch
``bfloat16`` tensor, or an array carrying the JAX package's
``bfloat16`` dtype) is written as its raw 16-bit patterns under the
dtype string ``"bfloat16"``, as the JAX package writes it, and reads
back as a CPU torch ``bfloat16`` tensor (``leaf_array`` gives its
``uint16`` bits where a numpy array is wanted): numpy has no bfloat16
of its own, and the port never loads ``ml_dtypes``, which gives it one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHUNK_SIZE = 512 * 1024  # paper §2: fixed 512 KiB chunks


@dataclass(frozen=True)
class TensorRange:
    name: str
    offset: int          # chunk-aligned start within the image
    nbytes: int
    dtype: str
    shape: tuple


@dataclass
class ImageLayout:
    tensors: dict            # name -> TensorRange (insertion = canonical order)
    image_size: int          # chunk-aligned total
    chunk_size: int = CHUNK_SIZE

    @property
    def num_chunks(self) -> int:
        return self.image_size // self.chunk_size

    def to_table(self) -> list:
        return [[t.name, t.offset, t.nbytes, t.dtype, list(t.shape)]
                for t in self.tensors.values()]

    @staticmethod
    def from_table(table, chunk_size=CHUNK_SIZE) -> "ImageLayout":
        tensors = {}
        end = 0
        for name, off, nb, dt, shp in table:
            tensors[name] = TensorRange(name, off, nb, dt, tuple(shp))
            end = max(end, off + nb)
        size = _align(end, chunk_size)
        return ImageLayout(tensors, size, chunk_size)


def _align(n: int, a: int) -> int:
    return ((n + a - 1) // a) * a


BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """The layout's dtype string of a numpy or torch dtype (or of such a
    string): numpy's name, ``"bfloat16"`` for either package's
    bfloat16."""
    return str(dtype).removeprefix("torch.")


def leaf_dtype(leaf) -> str:
    """The layout's dtype string of a leaf (``dtype_name``, module doc)."""
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return dtype_name(np.asarray(leaf).dtype)


def bf16_tensor(value) -> torch.Tensor:
    """A bfloat16 leaf as a torch ``bfloat16`` tensor: a tensor cast, or
    a numpy array's 16-bit patterns (``uint16`` bits, or the JAX
    package's bfloat16 array) copied into a CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.bfloat16)
    bits = np.asarray(value).view(np.int16).copy()    # C order, any ndim
    return torch.from_numpy(bits).view(torch.bfloat16)


def leaf_array(leaf) -> np.ndarray:
    """A leaf as a numpy array with its bytes: a torch tensor through
    the host, a bfloat16 tensor as its ``uint16`` bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def leaf_bytes(leaf) -> np.ndarray:
    """The leaf's bytes, C order, as a flat ``uint8`` array."""
    return np.ascontiguousarray(leaf_array(leaf)).view(np.uint8).reshape(-1)


def array_from_bytes(raw, dtype: str, shape: tuple):
    """The inverse of ``leaf_bytes`` for a layout's dtype string: a
    numpy array over `raw`, or a CPU torch ``bfloat16`` tensor (a copy)
    for ``"bfloat16"``."""
    if dtype == BF16:
        return bf16_tensor(np.frombuffer(raw, np.uint16).reshape(shape))
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def canonical_paths(tree) -> list:
    """Sorted (path_string, leaf) pairs for any nested dict/list pytree.

    The same "/"-joined dict-key / list-index strings and the same sort
    order as the JAX package's ``jax.tree_util`` flattening: dict keys,
    list and tuple indices, ``None`` holds no leaf, anything else is a
    leaf."""
    items = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            kids = ((str(k), node[k]) for k in sorted(node))
        elif isinstance(node, (list, tuple)):
            kids = ((str(i), v) for i, v in enumerate(node))
        else:
            items.append(("/".join(prefix), node))
            return
        for k, v in kids:
            walk(v, prefix + [k])

    walk(tree, [])
    items.sort(key=lambda kv: kv[0])
    return items


def build_layout(tree, chunk_size: int = CHUNK_SIZE) -> ImageLayout:
    tensors = {}
    offset = 0
    for name, leaf in canonical_paths(tree):
        nb = leaf_bytes(leaf).nbytes
        tensors[name] = TensorRange(name, offset, nb, leaf_dtype(leaf),
                                    tuple(np.shape(leaf)))
        offset = _align(offset + nb, chunk_size)
    return ImageLayout(tensors, _align(offset, chunk_size) or chunk_size,
                       chunk_size)


class ImageWriter:
    """Streams tensors into an in-memory image buffer (chunk-aligned)."""

    def __init__(self, layout: ImageLayout):
        self.layout = layout
        self.buf = np.zeros(layout.image_size, dtype=np.uint8)

    def put(self, name: str, arr) -> None:
        t = self.layout.tensors[name]
        raw = leaf_bytes(arr)
        assert raw.nbytes == t.nbytes, (name, raw.nbytes, t.nbytes)
        self.buf[t.offset:t.offset + t.nbytes] = raw

    def chunks(self):
        cs = self.layout.chunk_size
        for i in range(self.layout.image_size // cs):
            yield i, self.buf[i * cs:(i + 1) * cs].tobytes()


class StreamingImageWriter:
    """Chunk stream WITHOUT materializing the image buffer.

    ``ImageWriter`` allocates the whole chunk-aligned image up front —
    fine for benchmark-sized trees, pure waste for multi-GiB model
    checkpoints (the image is a second full copy of the host snapshot).
    Because every tensor starts at a chunk-aligned offset (``build_layout``
    invariant: no chunk ever spans two tensors), the chunk sequence can
    be produced one tensor at a time: view the tensor's bytes, slice
    chunk-size windows, zero-pad only the final partial window. Peak
    extra memory is ONE chunk instead of one image.

    ``chunks()`` yields ``(index, bytes)`` byte-identical to
    ``ImageWriter.chunks()`` over the same layout."""

    def __init__(self, layout: ImageLayout):
        self.layout = layout

    def chunks(self, items):
        """Yield (chunk_index, chunk_bytes) for ``items`` — the
        ``canonical_paths(tree)`` (name, leaf) pairs, in canonical
        order (asserted against the layout)."""
        cs = self.layout.chunk_size
        expect = iter(self.layout.tensors.values())
        next_idx = 0
        for name, leaf in items:
            t = next(expect)
            assert t.name == name, (
                f"stream order {name!r} != layout order {t.name!r}")
            assert t.offset == next_idx * cs, (name, t.offset, next_idx)
            raw = leaf_bytes(leaf)
            assert raw.nbytes == t.nbytes, (name, raw.nbytes, t.nbytes)
            nchunks = (_align(t.nbytes, cs) // cs) or 0
            for c in range(nchunks):
                win = raw[c * cs:(c + 1) * cs]
                if win.nbytes < cs:          # final partial: zero-pad
                    buf = np.zeros(cs, np.uint8)
                    buf[:win.nbytes] = win
                    yield next_idx, buf.tobytes()
                else:
                    yield next_idx, win.tobytes()
                next_idx += 1
        # trailing alignment (empty tree / zero-size tensors): the image
        # is at least one chunk and always chunk-aligned
        total = self.layout.image_size // cs
        zero = None
        while next_idx < total:
            if zero is None:
                zero = b"\x00" * cs
            yield next_idx, zero
            next_idx += 1


def read_tensor(layout: ImageLayout, name: str, read_fn):
    """Materialize one tensor via ``read_fn(offset, length) -> bytes``
    (``array_from_bytes``: a bfloat16 tensor comes back as a torch
    tensor)."""
    t = layout.tensors[name]
    return array_from_bytes(read_fn(t.offset, t.nbytes), t.dtype, t.shape)


# ------------------------------------------------------- shard-aware ranges

def shard_byte_ranges(t: TensorRange, dim_slices: list) -> list:
    """Byte ranges (absolute in the image) of a rectangular shard.

    dim_slices: per-dim (start, stop) index pairs. Ranges are coalesced
    runs of the innermost contiguous region.
    """
    shape = t.shape
    if not shape:
        return [(t.offset, t.nbytes)]
    itemsize = t.nbytes // max(1, int(np.prod(shape)))
    starts = [s for s, _ in dim_slices]
    stops = [e for _, e in dim_slices]
    # innermost contiguous run: trailing dims fully covered
    run_dims = len(shape)
    run = itemsize
    for d in range(len(shape) - 1, -1, -1):
        if starts[d] == 0 and stops[d] == shape[d]:
            run *= shape[d]
            run_dims = d
        else:
            run *= (stops[d] - starts[d])
            run_dims = d
            break
    # iterate over the outer index space
    outer_dims = range(0, run_dims)
    strides = []
    acc = itemsize
    for d in range(len(shape) - 1, -1, -1):
        strides.insert(0, acc)
        acc *= shape[d]
    ranges = []

    def rec(d, base):
        if d == run_dims:
            ranges.append((t.offset + base, run))
            return
        for i in range(starts[d], stops[d]):
            rec(d + 1, base + i * strides[d])

    rec(0, 0)
    # handle the broken dim inside the run (partial innermost block)
    if run_dims < len(shape):
        base_extra = sum(starts[d] * strides[d] for d in range(run_dims, len(shape)))
        ranges = [(off + base_extra, run) for off, run in ranges]
    return _coalesce(ranges)


def _coalesce(ranges: list) -> list:
    if not ranges:
        return []
    ranges = sorted(ranges)
    out = [list(ranges[0])]
    for off, ln in ranges[1:]:
        if off <= out[-1][0] + out[-1][1]:
            out[-1][1] = max(out[-1][1], off + ln - out[-1][0])
        else:
            out.append([off, ln])
    return [(o, l) for o, l in out]


def ranges_to_chunks(ranges: list, chunk_size: int = CHUNK_SIZE) -> list:
    """Sorted chunk indices touched by a set of byte ranges."""
    idx = set()
    for off, ln in ranges:
        if ln <= 0:
            continue
        idx.update(range(off // chunk_size, (off + ln - 1) // chunk_size + 1))
    return sorted(idx)
