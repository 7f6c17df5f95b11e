"""Process groups and rank helpers: the (data, bank[, model]) layout over
`torch.distributed`.

Counterpart of `spn4cir_tpu/parallel/mesh.py`. The JAX package drives one
`jax.sharding.Mesh` from a single controller; here every GPU runs its own
process (torchrun, or the `SPN4CIR_DIST_*` variables), and a `Mesh` is
this rank's coordinates on the (data, bank, model) axes with one process
group per axis. Ranks are laid out row-major over (data, bank, model),
`model` innermost as in the JAX `make_mesh`, so a host's contiguous ranks
hold whole bank and model groups and only the data axis crosses hosts
(`make_hybrid_mesh`). The reference's vendored LAVIS trains over NCCL DDP
(`blip24cir/lavis/common/dist_utils.py:57-91`); this module also carries
its rank helpers (`process_is_main`, `world_size`).

Where the JAX package places arrays with shardings (`shard_batch`,
`put_bank`, `replicate`), the ranks here hold their own rows: `local_rows`
is the rank's slice of a global batch over `data`, `bank_shard` its rows
of a padded bank over `bank`, and `broadcast_module` sends the parameters
from rank 0. Collectives are explicit, through the helpers at the end; a
rank outside any process group (one process) runs them as no-ops.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_BANK = "bank"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_BANK, AXIS_MODEL)

_DEVICE: Optional[torch.device] = None


def _truthy(value: Optional[str]) -> bool:
    return (value or "") not in ("", "0", "false")


def free_port() -> int:
    """A free TCP port on localhost (a one-process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group of a multi-process launch; returns True when
    this process is part of one.

    The gate is the JAX package's: explicit arguments, or the
    `SPN4CIR_DIST_COORDINATOR` ("host:port") / `SPN4CIR_DIST_NPROCS`
    variables, or `SPN4CIR_DISTRIBUTED` set (the CLIs' `--distributed`
    sets it). Without it, nothing is touched and False comes back. Past the
    gate, values missing from the arguments and the `SPN4CIR_DIST_*`
    variables come from torchrun's `MASTER_ADDR`/`MASTER_PORT`, `RANK`,
    `WORLD_SIZE` and `LOCAL_RANK`; one process with no address takes a free
    local port.

    The device is `device`, else `cuda:LOCAL_RANK` (the process id when
    LOCAL_RANK is unset) where CUDA is available, else the CPU. The backend
    is `backend`, else `SPN4CIR_DIST_BACKEND`, else NCCL for a CUDA device
    and gloo for the CPU; there is no fallback from one to the other. A
    launch that is misconfigured raises (the JAX docstring's rule,
    `spn4cir_tpu/parallel/mesh.py:102-105`)."""
    global _DEVICE
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("SPN4CIR_DIST_COORDINATOR") or None)
    if num_processes is None and env.get("SPN4CIR_DIST_NPROCS"):
        num_processes = int(env["SPN4CIR_DIST_NPROCS"])
    if process_id is None and env.get("SPN4CIR_DIST_PROC_ID"):
        process_id = int(env["SPN4CIR_DIST_PROC_ID"])
    explicit = coordinator_address is not None or num_processes is not None
    if not (explicit or _truthy(env.get("SPN4CIR_DISTRIBUTED"))):
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if num_processes != 1:
            raise RuntimeError(
                f"{num_processes} processes need a coordinator address "
                "(SPN4CIR_DIST_COORDINATOR or torchrun's MASTER_ADDR)")
        coordinator_address = f"localhost:{free_port()}"
    if not 0 <= process_id < num_processes:
        raise RuntimeError(f"process id {process_id} outside a world of "
                           f"{num_processes}")
    if device is None:
        local = int(env.get("LOCAL_RANK", process_id))
        device = (torch.device(f"cuda:{local}") if torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    backend = (backend or env.get("SPN4CIR_DIST_BACKEND")
               or ("nccl" if device.type == "cuda" else "gloo"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _DEVICE = device
    return True


def process_is_main() -> bool:
    """Rank 0 (or the only process) writes checkpoints, logs and JSON."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """This rank's place on the (data, bank, model) axes and the process
    group of each axis (None for one process: the collectives then do
    nothing). Every rank builds every group in the same order, as
    `new_group` requires."""

    def __init__(self, data: int = 1, bank: int = 1, model: int = 1,
                 device=None):
        sizes = {AXIS_DATA: data, AXIS_BANK: bank, AXIS_MODEL: model}
        world = world_size()
        if data * bank * model != world:
            raise ValueError(f"mesh data={data} x bank={bank} x "
                             f"model={model} != world size {world}")
        self.sizes = sizes
        self.rank = rank()
        self.coords = {AXIS_DATA: self.rank // (bank * model),
                       AXIS_BANK: (self.rank // model) % bank,
                       AXIS_MODEL: self.rank % model}
        self.device = torch.device(device) if device is not None else (
            _DEVICE or torch.device("cpu"))
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = dict.fromkeys(
            AXES)
        if dist.is_initialized():
            for axis in AXES:
                for ranks in self.axis_ranks(axis):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self.groups[axis] = group

    def axis_ranks(self, axis: str) -> List[List[int]]:
        """Every group of `axis`: the ranks that differ only in it."""
        d, b, m = (self.sizes[a] for a in AXES)
        ranks = [[(i * b + j) * m + k for i in range(d)
                  for j in range(b) for k in range(m)
                  if (i, j, k)[AXES.index(axis)] == n]
                 for n in range(self.sizes[axis])]
        # transpose: one group per fixed position of the other two axes
        return [list(g) for g in zip(*ranks)]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.sizes)

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    def part(self, axis: str = AXIS_DATA) -> Tuple[int, int]:
        """(index, size) on `axis`: the `part=` of the data iterators
        (`data.datasets`), which then decode only this rank's rows."""
        return self.coords[axis], self.sizes[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.sizes[AXIS_DATA]}, "
                f"bank={self.sizes[AXIS_BANK]}, "
                f"model={self.sizes[AXIS_MODEL]}, rank={self.rank})")


def make_mesh(data: Optional[int] = None, bank: int = 1, model: int = 1,
              device=None) -> Mesh:
    """(data, bank, model) over the world; `data` defaults to what is left
    of the world after bank x model."""
    world = world_size()
    if data is None or data == 0:
        if world % (bank * model):
            raise ValueError(f"world size {world} is not a multiple of bank="
                             f"{bank} x model={model}")
        data = world // (bank * model)
    return Mesh(data, bank, model, device)


def make_hybrid_mesh(data_per_slice: Optional[int] = None, bank: int = 1,
                     model: int = 1, num_slices: Optional[int] = None,
                     device=None) -> Mesh:
    """The multi-host layout: the data axis spans hosts (its gradient
    all-reduce moves parameter-sized traffic once a step), bank and model
    stay inside a host (their per-step and per-layer collectives are the
    latency-critical ones). torchrun numbers a host's processes
    contiguously, and the row-major rank layout puts data outermost, so
    this holds when each host's process count is a multiple of bank x
    model. The hosts are `num_slices`, else WORLD_SIZE / LOCAL_WORLD_SIZE;
    one host collapses to `make_mesh`."""
    world = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_slices = num_slices if num_slices is not None else max(world // local, 1)
    if n_slices <= 1:
        return make_mesh(data=data_per_slice, bank=bank, model=model,
                         device=device)
    per_slice = world // n_slices
    if data_per_slice is None:
        if per_slice % (bank * model):
            raise ValueError(f"{per_slice} processes a host do not hold "
                             f"bank={bank} x model={model}")
        data_per_slice = per_slice // (bank * model)
    if data_per_slice * bank * model != per_slice:
        raise ValueError((data_per_slice, bank, model, per_slice))
    return Mesh(n_slices * data_per_slice, bank, model, device)


# --------------------------------------------------------------------------
# rows of the global batch and of the bank
# --------------------------------------------------------------------------

def pad_bank_rows(bank, parts: int):
    """Zero-pad the bank's rows to a multiple of `parts` (a tensor or a
    `QuantBank`, whose values and scales pad together). The sharded losses
    count the true rows (`m_actual`), so the fill never reaches a logit."""
    from spn4cir_tpu_torch.ops.bank_kernels import QuantBank

    if isinstance(bank, QuantBank):
        return QuantBank(pad_bank_rows(bank.values, parts),
                         pad_bank_rows(bank.scales, parts))
    rem = (-bank.shape[0]) % parts
    if rem == 0:
        return bank
    pad = torch.zeros((rem, *bank.shape[1:]), dtype=bank.dtype,
                      device=bank.device)
    return torch.cat([bank, pad])


def shard_extent(m: int, parts: int, index: int) -> Tuple[int, int]:
    """(offset, rows) of shard `index` of a bank of `m` rows padded to a
    multiple of `parts`."""
    m_local = -(-m // parts)
    return index * m_local, m_local


def bank_shard(bank, mesh: Mesh, device=None):
    """(this rank's rows of `pad_bank_rows(bank, n_bank)`, their global
    offset). The rows move to `device` (default the mesh's): only the
    shard is copied, never the whole bank (a shard already on `device`
    is a view of it)."""
    from spn4cir_tpu_torch.ops.bank_kernels import QuantBank

    device = torch.device(device) if device is not None else mesh.device
    n = mesh.size(AXIS_BANK)
    offset, m_local = shard_extent(bank.shape[0], n, mesh.index(AXIS_BANK))

    def rows(t):
        part = t[offset:offset + m_local]
        short = m_local - part.shape[0]
        if short:
            part = torch.cat([part, part.new_zeros((short, *t.shape[1:]))])
        return part.to(device).contiguous()

    if isinstance(bank, QuantBank):
        return QuantBank(rows(bank.values), rows(bank.scales)), offset
    return rows(bank), offset


def local_rows(x, mesh: Mesh, axis: str = AXIS_DATA):
    """This rank's rows of a global batch (a tensor, an array, or a dict
    / list of them) over `axis`: dim 0 must divide by the axis size."""
    if isinstance(x, dict):
        return {k: local_rows(v, mesh, axis) for k, v in x.items()}
    if hasattr(x, "_fields"):  # a NamedTuple of batch-major fields
        return type(x)(*(local_rows(v, mesh, axis) for v in x))
    if isinstance(x, (list, tuple)):
        n, i = mesh.size(axis), mesh.index(axis)
        if len(x) % n:
            raise ValueError(f"{len(x)} rows do not split over {axis}={n}")
        step = len(x) // n
        return type(x)(x[i * step:(i + 1) * step])
    n, i = mesh.size(axis), mesh.index(axis)
    if x.shape[0] % n:
        raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                         f"split over {axis}={n}")
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


# --------------------------------------------------------------------------
# collectives (no-ops outside a process group)
# --------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns `t`."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of `group`, in rank order (no gradient)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """`gather_rows` with its gradient: the backward sums every rank's
    gradient of the gathered rows (an all-reduce, which gloo and NCCL take
    on CUDA and CPU tensors alike) and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.rows = t.shape[0]
        return gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        i = dist.get_rank(ctx.group)
        return grad[i * ctx.rows:(i + 1) * ctx.rows], None


def gather_rows_with_grad(t: torch.Tensor, group) -> torch.Tensor:
    """All ranks' rows with their gradient (LAVIS's `all_gather_with_grad`,
    `blip24cir/lavis/models/base_model.py:220-236`)."""
    if group is None:
        return t
    return _GatherRows.apply(t, group)


def _flat_grads(params: Sequence[torch.nn.Parameter]):
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    return by_type.values()


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group) -> None:
    """Sum the gradients of `params` over `group`, one flat buffer per
    dtype (a parameter without a gradient is left alone: every rank of the
    group runs the same graph, so the same ones are missing)."""
    if group is None:
        return
    for grads in _flat_grads(params):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_str(text: str, src: int = 0) -> str:
    """Rank `src`'s string on every rank (an output path with a time
    stamp, say)."""
    if not dist.is_initialized():
        return text
    box = [text]
    dist.broadcast_object_list(box, src)
    return box[0]


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers to every rank."""
    if not dist.is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)
