"""Device mesh: split the ray batch over several devices.

Port of ``rwrt_tpu/parallel/sharding.py``, with its design:

- one mesh axis, ``'rays'`` (pure data parallelism);
- the background field stack is small and copied to every device;
- the (5, R) ray state and every per-lane tensor are split along R into
  contiguous shards, one per mesh entry; R is padded with NaN lanes (dead
  rays) to a multiple of the mesh size;
- the shards never talk to each other: each is one launch of the branch's
  whole-run kernel on its device (``tracer._run_sharded``), as the JAX
  package's shard_map program holds no collectives. The rows come back to
  one device when the run gathers them.

A lane's rows never depend on another lane's, so a run over a mesh is
bitwise the same run without one (rows, (ug, vg), attempts, truncation),
where the JAX package's sharded runs differ from its single-device ones by
codegen ulps.

A ``Mesh`` is a tuple of ``torch.device``s, one per shard. Entries may
repeat: shards that share a device run one after another on its current
stream, and a mesh of one card repeated (``Mesh((torch.device("cuda",
0),) * 3)``) or of the CPU repeated is the port's form of the JAX
package's virtual devices. One process drives every device, as JAX's mesh
is single-controller; no ``torch.distributed``.

The JAX module's ``ray_sharding`` and ``replicated`` build
``jax.sharding.NamedSharding`` objects for ``jax.device_put``; PyTorch
has no such objects (a shard is a tensor on its device), so they have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``devices`` (one shard each, entries may repeat),
    its one axis ``'rays'``. All entries are of one device type; a CUDA
    entry names its card (``cuda`` alone is taken as the current one)."""

    devices: tuple
    axis_names: tuple = (RAY_AXIS,)

    def __post_init__(self):
        devs = tuple(_concrete(torch.device(d)) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh entries must be of one device type, "
                             f"got {[str(d) for d in devs]}")
        if tuple(self.axis_names) != (RAY_AXIS,):
            raise ValueError(f"the mesh's one axis is {RAY_AXIS!r}, got "
                             f"{self.axis_names!r}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", (RAY_AXIS,))

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def shape(self) -> dict:
        """{axis name: shards}, the run report's ``"mesh"``."""
        return {RAY_AXIS: self.size}


def _concrete(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (None: all of
    them), or ``n_devices`` entries of the CPU (None: one).

    Raises where fewer cards exist than asked for, where the JAX package's
    ``devices[:n]`` quietly takes fewer: a run never spreads over fewer
    devices than its configuration names."""
    if n_devices is not None and int(n_devices) < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if device_type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}; 'cuda' or "
                         "'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise RuntimeError(f"a mesh of {n_devices or 'all'} CUDA devices "
                           f"needs that many cards; {count} available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def check_mesh(mesh, device) -> Optional[Mesh]:
    """``mesh`` as a run over a state on ``device`` takes it: None, or a
    ``Mesh`` (else TypeError) of that device type (else ValueError: a mesh
    of CUDA entries never runs a CPU state, nor the other way)."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a rwrt_tpu_torch.parallel.sharding."
                        f"Mesh or None, not {type(mesh).__name__}")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"a mesh of {mesh.device_type} devices cannot run "
                         f"a state on {device}")
    return mesh


def pad_rays(y: torch.Tensor, n_shards: int):
    """Pad the trailing ray axis to a multiple of ``n_shards``: with NaN
    lanes, which behave exactly like dead rays (an integer tensor, the
    member map, with 0: member 0). Returns (padded, original R)."""
    r = y.shape[-1]
    pad = (-r) % n_shards
    if pad == 0:
        return y, r
    fill = float("nan") if y.is_floating_point() else 0
    tail = torch.full(tuple(y.shape[:-1]) + (pad,), fill, dtype=y.dtype,
                      device=y.device)
    return torch.cat([y, tail], dim=-1), r


def shard_rays(y: torch.Tensor, mesh: Mesh) -> list:
    """The contiguous per-entry slices of ``y`` along its trailing ray
    axis (a multiple of the mesh size), each on its entry's device."""
    r = y.shape[-1]
    if r % mesh.size:
        raise ValueError(f"{r} lanes do not split over {mesh.size} shards; "
                         "pad them first (pad_rays)")
    w = r // mesh.size
    return [y[..., i * w:(i + 1) * w].to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple):
        vals = [_to(x, device) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def replicate(tree, mesh: Mesh) -> list:
    """The tensors of ``tree`` (a tensor, or a tuple or NamedTuple such as
    the ``Background``) on every mesh entry's device, in mesh order: one
    copy per distinct device, which repeated entries share (on the tree's
    own device, the tree itself)."""
    copies = {}
    out = []
    for d in mesh.devices:
        if d not in copies:
            copies[d] = _to(tree, d)
        out.append(copies[d])
    return out


def gather_rays(parts, device) -> torch.Tensor:
    """Concatenate per-shard tensors along the trailing ray axis on
    ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=-1)


def device_guard(device: torch.device):
    """A context in which ``device`` is the current CUDA device, so that a
    kernel launched through the library goes to it (a no-op for the
    CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
