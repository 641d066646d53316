"""Device meshes over ``torch.distributed`` ranks.

Port of ``llm_interpretation_replication_tpu/parallel/mesh.py``.  The
reference builds a ``jax.sharding.Mesh`` over the devices of one
controlling process.  PyTorch runs one process a rank (SPMD, as
``torchrun`` launches it), so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks with the
reference's axis names and order, ``("data", "pipe", "model", "seq")``:
one process group a mesh axis.  On the card the backend is NCCL; the CPU
(gloo) is used only when the caller asks for it, and nothing falls back
from one to the other.

``enumerate_mesh_shapes`` and ``mesh_shape_for`` are the shape arithmetic
the plan search reads; ``axis_size``, ``axis_rank`` and ``axis_group`` read
one axis of a mesh (a missing mesh is one rank on every axis).  The scoring
engine's placements are ``data_rows`` (a rank's rows of a batch) with
``gather_rows`` back, and ``agree`` (every rank's MAX of a host flag).  The
reference's replicated placement needs no function: one process a rank,
every rank holds a replicated tensor whole.

The control channel.  The reference has one controller, so a host
decision (which requests a serve scheduler launches, which it admits
mid-decode) is taken once.  Here every rank runs the host code, and a
decision read off a clock would differ between ranks.  So one rank
decides (:func:`leader`, the mesh's first rank) and sends the decision to
the others before any rank acts on it (:func:`decide`), on a gloo group
over the mesh's ranks (:func:`control_group`): the decisions are host
objects, so they never touch the card.  :func:`make_mesh` makes the
group; under a gloo world it is the world itself.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS)

# the control channels: a gloo group for each mesh's ranks, by rank tuple
_CONTROL = {}
# the seconds a collective waits (initialize_distributed's ``timeout``)
_TIMEOUT = [None]


def mesh_shape(n_devices: int, data: Optional[int] = None, model: int = 1,
               seq: int = 1, pipe: int = 1) -> Tuple[int, int, int, int]:
    """The (data, pipe, model, seq) shape :func:`make_mesh` builds over
    ``n_devices`` ranks, with its errors: ``data`` defaults to whatever is
    left after pipe x model x seq divides the count."""
    if data is None:
        if n_devices % (pipe * model * seq):
            raise ValueError(
                f"{n_devices} devices not divisible by pipe={pipe} × "
                f"model={model} × seq={seq}")
        data = n_devices // (pipe * model * seq)
    if data * pipe * model * seq != n_devices:
        raise ValueError(
            f"mesh {data}×{pipe}×{model}×{seq} != {n_devices} devices")
    return data, pipe, model, seq


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    seq: int = 1,
    pipe: int = 1,
    devices: Optional[Sequence[int]] = None,
):
    """Build a (data, pipe, model, seq) ``DeviceMesh`` over ``devices``
    (ranks; default every rank of the world), laid out as the reference
    lays devices out: the pipe axis between data and model, so pipeline
    neighbours sit in one contiguous block and the tensor-parallel groups
    are the innermost runs of ranks.

    Needs a process group (:func:`initialize_distributed`); the mesh's
    device type follows its backend (``cuda`` for NCCL, ``cpu`` for gloo).
    Every rank of the world must call this with the same arguments: each
    axis's groups are made collectively."""
    import torch
    import torch.distributed as dist

    def need_group():
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs a process group: call "
                               "initialize_distributed first")

    if devices is None:
        need_group()
        devices = range(dist.get_world_size())
    ranks = [int(r) for r in devices]
    shape = mesh_shape(len(ranks), data, model, seq, pipe)    # its errors first
    need_group()
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXES)
    if len(ranks) > 1 and tuple(ranks) not in _CONTROL:
        _CONTROL[tuple(ranks)] = _new_control_group(ranks)
    return mesh


def _new_control_group(ranks):
    """A gloo group over ``ranks`` (the world's group under a gloo world
    that they fill); every rank of the world calls this."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo" and list(ranks) == list(
            range(dist.get_world_size())):
        return dist.group.WORLD
    extra = {} if _TIMEOUT[0] is None else dict(
        timeout=datetime.timedelta(seconds=_TIMEOUT[0]))
    return dist.new_group(ranks=list(ranks), backend="gloo", **extra)


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The mesh's ranks, in its layout's order (rank 0 alone without a
    mesh)."""
    if mesh is None:
        return (0,)
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def leader(mesh) -> int:
    """The rank that takes the mesh's host decisions: its first rank."""
    return mesh_ranks(mesh)[0]


def is_leader(mesh) -> bool:
    """Whether this process is :func:`leader` (True without a mesh or a
    process group)."""
    import torch.distributed as dist

    if mesh is None or not dist.is_initialized():
        return True
    return dist.get_rank() == leader(mesh)


def control_group(mesh):
    """The gloo group of the mesh's ranks (None for a mesh of one rank)."""
    if mesh is None or mesh.size() == 1:
        return None
    return _CONTROL[mesh_ranks(mesh)]


def decide(decision, mesh):
    """The leader's ``decision`` (any picklable host object) on every rank
    of ``mesh``: the leader passes it and the others pass None.  Blocks a
    follower until the leader sends; raises when the group's timeout
    expires or the leader's process is gone.  ``decision`` itself on a
    mesh of one rank."""
    group = control_group(mesh)
    if group is None:
        return decision
    import torch.distributed as dist

    box = [decision if is_leader(mesh) else None]
    dist.broadcast_object_list(box, src=leader(mesh), group=group)
    return box[0]


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None when
    the axis has one rank (its collectives are the identity)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def enumerate_mesh_shapes(
    n_devices: int,
    max_model: Optional[int] = None,
    max_pipe: int = 1,
) -> Tuple[Tuple[int, int, int], ...]:
    """Every (data, pipe, model) factorization of ``n_devices`` (seq=1),
    each satisfying ``data * pipe * model == n_devices``.
    ``max_model``/``max_pipe`` bound the model/pipe degrees; shapes are
    ordered data-major (pure data parallelism first)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    shapes = []
    for pipe in range(1, max(1, max_pipe) + 1):
        if n_devices % pipe:
            continue
        rem = n_devices // pipe
        for model in range(1, rem + 1):
            if rem % model:
                continue
            if max_model is not None and model > max_model:
                continue
            shapes.append((rem // model, pipe, model))
    return tuple(sorted(set(shapes), key=lambda s: (-s[0], s[1], s[2])))


def carve_slices(
    n_slices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    counts: Optional[Sequence[int]] = None,
) -> Tuple[Tuple[int, ...], ...]:
    """Partition the world's ranks into per-replica slices, contiguous runs
    each (a replica's collectives never straddle another replica's ranks).

    - ``counts=(4, 2, 2)``: explicit per-slice rank counts for a
      heterogeneous roster; must sum to the rank count.
    - ``n_slices=N``: N equal slices; the rank count must divide.

    With FEWER ranks than slices every slice degenerates to the full rank
    list: shared placement.  ``devices`` defaults to every rank of the
    world (rank 0 alone without a process group)."""
    if devices is None:
        import torch.distributed as dist

        devices = range(dist.get_world_size() if dist.is_initialized() else 1)
    devices = tuple(devices)
    n = len(devices)
    if counts is not None:
        counts = tuple(int(c) for c in counts)
        if n_slices is not None and len(counts) != n_slices:
            raise ValueError(
                f"counts has {len(counts)} entries for n_slices={n_slices}")
        if any(c < 1 for c in counts):
            raise ValueError(f"every slice needs >= 1 device, got {counts}")
        if n < len(counts):
            return tuple(devices for _ in counts)
        if sum(counts) != n:
            raise ValueError(
                f"counts {counts} sum to {sum(counts)}, not {n} devices")
        out, at = [], 0
        for c in counts:
            out.append(devices[at:at + c])
            at += c
        return tuple(out)
    if n_slices is None or n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if n < n_slices:
        return tuple(devices for _ in range(n_slices))
    if n % n_slices:
        raise ValueError(
            f"{n} devices not divisible into {n_slices} equal slices; "
            f"pass counts= for a heterogeneous split")
    per = n // n_slices
    return tuple(devices[i * per:(i + 1) * per] for i in range(n_slices))


def mesh_shape_for(n_devices: int, want_model: int = 1,
                   want_seq: int = 1) -> Tuple[int, int, int]:
    """Largest data axis given desired model/seq parallelism, shrinking model
    then seq until they divide the device count."""
    model, seq = want_model, want_seq
    while n_devices % (model * seq) and model > 1:
        model //= 2
    while n_devices % (model * seq) and seq > 1:
        seq //= 2
    return n_devices // (model * seq), model, seq


class Placement(NamedTuple):
    """A mesh and a spec (a tuple of axis names or None, one a dim): the
    port's ``NamedSharding``."""
    mesh: object
    spec: Tuple


def replicated(mesh) -> Placement:
    return Placement(mesh, ())


def data_sharded(mesh, rank: int = 2) -> Placement:
    """Batch-leading arrays sharded over the data axis."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (rank - 1))


def data_rows(x, mesh, dim: int = 0):
    """This rank's share of a batch's rows along ``data`` (the port's
    counterpart of the reference engine's ``_put``, ``P(DATA_AXIS, ...)``):
    the rank's contiguous block of ``x`` along ``dim``, ``ceil(rows / n)``
    rows.  The rule the port keeps is not ``jax.device_put``'s, which
    raises on rows the data axis does not divide: the engine's pooled
    flushes, rings and look-ahead subsets have such row counts, so a short
    block is filled out with copies of row 0, which :func:`gather_rows`
    with ``rows=`` drops again.  ``x`` itself with one data rank."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return x
    rows = x.shape[dim]
    per = -(-rows // n)
    lo = min(axis_rank(mesh, DATA_AXIS) * per, rows)
    real = min(per, rows - lo)
    block = x.narrow(dim, lo, real)
    if real == per:
        return block
    import torch

    fill = list(x.shape)
    fill[dim] = per - real
    return torch.cat([block, x.narrow(dim, 0, 1).expand(fill)], dim)


def gather_rows(xs, mesh, dims, rows: Optional[int] = None):
    """Each tensor of ``xs`` whole from every data rank's block (the
    inverse of :func:`data_rows`) along its axis in ``dims``, on every
    rank; ``rows`` drops the blocks' padding.  An axis of ``None`` stacks
    the ranks' tensors on a new leading axis instead.  One ``all_gather``
    moves the bytes of all of them: every rank's blocks have the same
    shapes."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return [x if d is not None else x[None] for x, d in zip(xs, dims)]
    import torch
    import torch.distributed as dist

    parts, spans, at = [], [], 0
    for x in xs:
        raw = x.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 16            # each span 16-byte aligned
        parts += [raw, raw.new_zeros(pad)] if pad else [raw]
        spans.append((at, raw.numel()))
        at += raw.numel() + pad
    flat = torch.cat(parts)
    got = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(got, flat, group=axis_group(mesh, DATA_AXIS))
    out = []
    for x, d, (start, size) in zip(xs, dims, spans):
        blocks = [g[start:start + size].view(x.dtype).reshape(x.shape)
                  for g in got]
        if d is None:
            out.append(torch.stack(blocks))
            continue
        whole = torch.cat(blocks, d)
        if rows is not None and rows < whole.shape[d]:
            whole = whole.narrow(d, 0, rows).contiguous()
        out.append(whole)
    return out


def agree(flag: int, mesh) -> int:
    """The largest ``flag`` over every rank of ``mesh`` (an all-reduce MAX
    of one small int, axis by axis): the ranks' agreement on a host
    decision such as an OOM on one of them.  ``flag`` without a mesh."""
    if mesh is None or mesh.size() == 1:
        return int(flag)
    import torch
    import torch.distributed as dist

    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    for axis in AXES:
        group = axis_group(mesh, axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    device: str = "cuda",
    timeout: Optional[float] = None,
) -> bool:
    """Bring up the default process group: NCCL on ``device="cuda"`` (the
    rank's card: ``LOCAL_RANK``), gloo on ``device="cpu"``.

    Reads torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` when the arguments are not given.  ``init_method`` takes a
    rendezvous of the caller's own (``file://<path>`` needs no network).
    Does nothing and returns False without a world (no address, no
    ``init_method`` and at most one process); returns True once a group
    is up (at once when one already is).  ``timeout`` (seconds) bounds
    how long a collective waits before it raises."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "0")) or None
    if process_id is None:
        pid = os.environ.get("RANK")
        process_id = int(pid) if pid is not None else None
    if init_method is None and not coordinator_address \
            and num_processes in (None, 1):
        return False
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    rank = process_id or 0
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') needs "
                               "a CUDA device; pass device='cpu' for gloo")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    extra = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes or 1, rank=rank, **extra)
    _CONTROL.clear()
    _TIMEOUT[0] = timeout
    world = tuple(range(dist.get_world_size()))
    if len(world) > 1:
        # host decisions travel beside the NCCL world, never on the card
        _CONTROL[world] = _new_control_group(world)
    return True
