"""Device meshes for multi-device proving.  Port of halo2tpu/parallel/mesh.py.

halo2tpu's mesh is single-controller: one process holds a jax Mesh and
shard_map + all_to_all exchange blocks between its devices.  The port keeps
that shape without jax: a `Mesh` is a 1-D or 2-D array of torch devices
with axis names, one process drives every device, and the collectives are
methods over lists of per-shard tensors built from `Tensor.to(device)` and
`torch.cat` (peer to peer between two GPUs of one node, local copies on one
device).  A device may repeat, so one card or the CPU can carry D shards:
the block exchanges then run for real, at no gain.

A `Placement` is the counterpart of a NamedSharding (a mesh and, for each
tensor dimension, the mesh axis that splits it or None); `put` splits a
tensor into a `Sharded` value, its blocks in the mesh's device order, and
`Sharded.gather` joins them again.  The prover's vectors are row-sharded
values: D contiguous row blocks, block d on mesh.flat[d].
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..fields.jfield import device_of


def on_device(dev: torch.device):
    """Context making `dev` the current CUDA device (the kernels launch on
    the current device); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Mesh:
    """An array of torch devices with one name an axis.  devices: a (nested)
    list of devices or device specs, 1-D or 2-D; a device may repeat."""

    def __init__(self, devices, axis_names=("shard",)):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")
        if not flat:
            raise ValueError("empty mesh")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list:
        """The devices in row-major order (block order of a Sharded)."""
        return list(self.devices.reshape(-1))

    @property
    def first(self) -> torch.device:
        return self.flat[0]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.flat]}, shape={self.shape})")

    def sub(self, axis: str, index: int) -> "Mesh":
        """The 1-D mesh along `axis` at position `index` of the other axis
        of a 2-D mesh."""
        if self.devices.ndim != 2:
            raise ValueError("sub() needs a 2-D mesh")
        a = self.axis_names.index(axis)
        row = self.devices[index] if a == 1 else self.devices[:, index]
        return Mesh(list(row), (axis,))

    # -- collectives over per-shard lists (1-D meshes) ----------------------
    def all_to_all(self, blocks: list, split_dim: int, concat_dim: int):
        """jax.lax.all_to_all(tiled=True) over the mesh: each block splits
        into `size` chunks along split_dim, chunk j goes to device j, and
        device j joins what it receives along concat_dim in source order."""
        D = self.size
        if D == 1:
            return list(blocks)
        parts = [b.chunk(D, split_dim) for b in blocks]
        out = []
        for j, dev in enumerate(self.flat):
            out.append(torch.cat([p[j].to(dev, non_blocking=True)
                                  for p in parts], concat_dim))
        return out

    def split(self, t, dim: int = 0) -> list:
        """A tensor cut into `size` equal blocks along dim, block d on
        device d (a view when it is already there)."""
        return [c.to(dev, non_blocking=True)
                for c, dev in zip(t.chunk(self.size, dim), self.flat)]

    def gather(self, blocks: list, dim: int = 0, device=None):
        """The blocks joined along dim on `device` (default: the first)."""
        dev = self.first if device is None else torch.device(device)
        if len(blocks) == 1:
            return blocks[0].to(dev)
        return torch.cat([b.to(dev, non_blocking=True) for b in blocks], dim)

    def replicate(self, t) -> list:
        """t on every device of the mesh (one tensor a block)."""
        cache: dict = {}
        out = []
        for dev in self.flat:
            if dev not in cache:
                cache[dev] = t.to(dev, non_blocking=True)
            out.append(cache[dev])
        return out


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device="cuda") -> Mesh:
    """A 1-D mesh over the first n_devices devices of type `device` (all of
    them if None).  Raises when fewer exist; never repeats a device (build
    Mesh([torch.device("cuda:0")] * 4) for four shards of one card)."""
    kind = torch.device(device).type
    if kind == "cuda":
        device_of("cuda")               # raises without CUDA
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        have = [torch.device("cpu")]
    else:
        raise ValueError(f"make_mesh: device type {kind}")
    need = len(have) if n_devices is None else n_devices
    if need < 1 or need > len(have):
        raise RuntimeError(f"make_mesh: need {need} {kind} devices, have "
                           f"{len(have)}")
    return Mesh(have[:need], (axis,))


class Placement:
    """How a tensor lies on a mesh (NamedSharding): spec[k] names the mesh
    axis that splits dimension k, or None (trailing dimensions: None).  A
    mesh axis no dimension names holds copies."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)
        for a in self.spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"placement names axis {a!r} of a mesh with "
                                 f"axes {mesh.axis_names}")

    def _slices(self, shape, pos) -> tuple:
        """The index of the block at mesh position `pos` (a tuple)."""
        sl = []
        for k, size in enumerate(shape):
            a = self.spec[k] if k < len(self.spec) else None
            if a is None:
                sl.append(slice(None))
                continue
            parts = self.mesh.shape[a]
            if size % parts:
                raise ValueError(f"dimension {k} of size {size} does not "
                                 f"split over {parts} devices of axis {a!r}")
            step = size // parts
            i = pos[self.mesh.axis_names.index(a)]
            sl.append(slice(i * step, (i + 1) * step))
        return tuple(sl)

    def put(self, t) -> "Sharded":
        """t split into its blocks, each contiguous on its device."""
        if isinstance(t, Sharded):
            t = t.gather()
        blocks = []
        for pos in np.ndindex(*self.mesh.devices.shape):
            blk = t[self._slices(t.shape, pos)]
            blocks.append(blk.contiguous().to(self.mesh.devices[pos],
                                              non_blocking=True))
        return Sharded(self, blocks, tuple(t.shape))


class Sharded:
    """A tensor of global `shape` as blocks over placement's mesh, block i
    on mesh.flat[i] (row-major mesh order)."""

    def __init__(self, placement: Placement, blocks: list, shape: tuple):
        self.placement = placement
        self.blocks = list(blocks)
        self.shape = torch.Size(shape)

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def gather(self, device=None):
        """The whole tensor on `device` (default: the mesh's first)."""
        pl, mesh = self.placement, self.placement.mesh
        dev = mesh.first if device is None else torch.device(device)
        b0 = self.blocks[0]
        out = torch.empty(self.shape, dtype=b0.dtype, device=dev)
        seen = set()
        for i, pos in enumerate(np.ndindex(*mesh.devices.shape)):
            sl = pl._slices(self.shape, pos)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl] = self.blocks[i].to(dev)
        return out

    def nbytes(self) -> int:
        return sum(b.nelement() * b.element_size() for b in self.blocks)

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, spec="
                f"{self.placement.spec}, {self.placement.mesh})")


def shard_leading(mesh: Mesh, axis: str = "shard") -> Placement:
    """Dimension 0 split over `axis`."""
    return Placement(mesh, (axis,))


def replicated(mesh: Mesh) -> Placement:
    """A copy on every device."""
    return Placement(mesh, ())

