"""Ranks, the ``(data, model)`` grid and the tensor-parallel layout.

Counterpart of ``flexdm_tpu/parallel/mesh.py``.  JAX runs one process
over a ``Mesh`` of devices and lets GSPMD place the arrays; the port runs
one process per device, a *rank*, over ``torch.distributed``, and places
them itself.  A port rank is one device of JAX's single-process mesh:
``--num_devices N --model_parallel M`` makes N ranks in a grid of
``D = N / M`` data ranks by ``M`` model ranks, row-major as ``make_mesh``
reshapes its devices: rank ``r`` is data rank ``r // M`` and model rank
``r % M``.  The ranks of one data rank form its *model group*, the ranks
of one model rank its *data group*.

* **Batches.**  ``config.batch_size`` is the global batch.  The ranks of
  one model group see the same rows; data rank ``d`` takes rows
  ``[d B/D, (d+1) B/D)`` (:meth:`Grid.rows`).  When ``B % D != 0`` every
  rank takes the whole batch, as JAX's replicated placement does (logged
  once).  JAX's multi-process hosts are nodes under ``torchrun``: each
  loads a 1-in-``num_hosts`` stride of the train records and its slice of
  the global batch (``DataLoader(num_hosts, host_id)``).
* **Parameters.**  :func:`partition_spec` is JAX's rule set, matched on
  the port's parameter names as :mod:`..convert` maps them: attention
  ``query``/``key``/``value``, ``mlp_0`` and ``conditional`` are
  column-parallel (output features split over ``model``), ``out`` and
  ``mlp_1`` row-parallel (contraction split), the ``decoder_*`` heads and
  the encoder's ``input_*`` tables and Dense kernels split their feature
  axis, and a dimension that does not divide ``M`` stays whole.  The same
  rules cover the baselines: BART's ``CrossBlock`` attentions and MLP and
  CanvasVAE's ``conditional`` Dense split, and the CVAE layers
  (``enc_*``, ``dec_*``, ``prior_*``), ``prior_head``, ``length_fc``,
  ``bos`` and the position tables stay whole.
  :func:`shard_params` keeps a rank's slice of each split parameter (and
  of its Adam moments, so optimizer memory falls with ``M``), marked with
  a :class:`~.layers.Split`; :func:`gather_params` puts the whole tensors
  back together (checkpoints are written whole, in the single-device
  format).  The collectives that GSPMD would insert are in
  :mod:`.layers`.

Process groups: :func:`spawn` starts N ranks on one host (``--num_devices
N`` without ``torchrun``), :func:`init_grid` joins one rank to the group
and builds the data and model subgroups, :func:`from_env` does so under
``torchrun`` (``RANK``/``WORLD_SIZE``/``LOCAL_RANK``).  A card rank uses
``nccl``, a CPU rank ``gloo``; several ranks may share one card under
``gloo`` (a keyword of the entry points, not a flag).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .layers import Split, split_of

logger = logging.getLogger(__name__)

MODEL_AXIS = "model"

# Dense layers whose OUTPUT features split over `model` (column-parallel)
# and whose INPUT (contraction) dim splits (row-parallel): one reduce per
# pair (flexdm_tpu/parallel/mesh.py:38-43).
_COLUMN_PARALLEL = ("query", "key", "value", "mlp_0", "conditional")
_ROW_PARALLEL = ("out", "mlp_1")

# A collective that waits longer than this fails its rank (a rank that
# died leaves the others waiting).
COLLECTIVE_TIMEOUT_S = 600


@dataclasses.dataclass
class Grid:
    """One rank's place in the ``(data, model)`` grid and its groups."""

    rank: int
    world_size: int
    model_size: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    num_hosts: int = 1
    host_id: int = 0
    _warned: set = dataclasses.field(default_factory=set, repr=False)

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def splits(self, batch: int, ranks: Optional[int] = None) -> bool:
        """Whether a batch of ``batch`` rows splits over ``ranks`` data
        ranks (default: all of them); logs once per size if not."""
        ranks = self.data_size if ranks is None else ranks
        if batch % ranks == 0:
            return True
        if (batch, ranks) not in self._warned:
            self._warned.add((batch, ranks))
            logger.warning(
                "batch dim %d does not divide the data ranks (%d); every "
                "rank takes the whole batch (no data parallelism for it)",
                batch, ranks)
        return False

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` rows."""
        if not self.splits(batch):
            return slice(0, batch)
        k = batch // self.data_size
        return slice(self.data_rank * k, (self.data_rank + 1) * k)

    def host_rows(self, host_batch: int) -> slice:
        """This rank's rows of its host's ``host_batch`` rows (the host's
        slice of the global batch; the whole batch on one host)."""
        per_host = self.data_size // self.num_hosts
        if not self.splits(host_batch, per_host):
            return slice(0, host_batch)
        k = host_batch // per_host
        local = self.data_rank % per_host
        return slice(local * k, (local + 1) * k)

    def sum_over_data(self, values: Sequence[float],
                      batch: int) -> List[float]:
        """``values`` (sums over this rank's rows of batches of ``batch``
        rows) summed over the data ranks, in float64.  When the batch does
        not split, every rank holds the whole sums already."""
        if not self.splits(batch):
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, group=self.data_group)
        return t.tolist()

    def mean_over_data(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each tensor's mean over the data ranks, through one all-reduce
        of a flat bucket.  The results are copies, not views of the
        bucket: a view at an unaligned offset takes the foreach kernels'
        unvectorised path, whose sums round otherwise.  One data rank
        returns ``tensors`` as they are."""
        if self.data_size == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        flat.div_(self.data_size)
        return [part.view_as(t).clone() for t, part in
                zip(tensors, flat.split([t.numel() for t in tensors]))]


def _groups(world_size: int, model_size: int, rank: int):
    """Every data and model subgroup, made in the same order on every rank
    (``new_group`` is collective); returns this rank's two."""
    data_size = world_size // model_size
    model_group = data_group = None
    for d in range(data_size):
        ranks = list(range(d * model_size, (d + 1) * model_size))
        group = dist.new_group(ranks)
        if rank in ranks:
            model_group = group
    for m in range(model_size):
        ranks = list(range(m, world_size, model_size))
        group = dist.new_group(ranks)
        if rank in ranks:
            data_group = group
    return data_group, model_group


def init_grid(rank: int, world_size: int, model_parallel: int, device,
              backend: str, init_method: str, num_hosts: int = 1,
              host_id: int = 0) -> Grid:
    """Join rank ``rank`` to the process group and build its grid."""
    if model_parallel < 1 or world_size % model_parallel:
        raise ValueError(f"--model_parallel {model_parallel} must divide "
                         f"--num_devices {world_size}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return new_grid(model_parallel, device, num_hosts, host_id)


def new_grid(model_parallel: int, device, num_hosts: int = 1,
             host_id: int = 0) -> Grid:
    """Another grid over the ranks of the joined group (its subgroups are
    new; every rank must make the same grids in the same order)."""
    rank, world_size = dist.get_rank(), dist.get_world_size()
    if model_parallel < 1 or world_size % model_parallel:
        raise ValueError(f"--model_parallel {model_parallel} must divide "
                         f"--num_devices {world_size}")
    data_group, model_group = _groups(world_size, model_parallel, rank)
    return Grid(rank, world_size, model_parallel, torch.device(device),
                data_group, model_group, num_hosts, host_id)


def from_env(model_parallel: int, device: str,
             backend: Optional[str] = None) -> Grid:
    """Join the group ``torchrun`` describes: rank ``RANK`` of
    ``WORLD_SIZE`` on ``cuda:LOCAL_RANK`` (``device='cpu'``: the CPU);
    each node is a host of ``LOCAL_WORLD_SIZE`` ranks."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        device = f"cuda:{local_rank}"
    if local_world % model_parallel:
        raise ValueError(f"--model_parallel {model_parallel} must divide "
                         f"the ranks of a node ({local_world})")
    return init_grid(rank, world, model_parallel, device,
                     backend or default_backend(device), "env://",
                     num_hosts=world // local_world,
                     host_id=rank // local_world)


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def teardown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_devices(num_devices: int, device: str,
                 devices: Optional[Sequence[str]] = None) -> List[str]:
    """The device of each of ``num_devices`` ranks on this host:
    ``devices`` if given, else the CPU for every rank
    (``device='cpu'``) or one card each (``cuda:r``; more ranks than
    cards raises)."""
    if devices is not None:
        if len(devices) != num_devices:
            raise ValueError(f"{len(devices)} devices for {num_devices} "
                             "ranks")
        return list(devices)
    if torch.device(device).type == "cpu":
        return ["cpu"] * num_devices
    available = torch.cuda.device_count()
    if num_devices > available:
        raise ValueError(f"--num_devices {num_devices} > the "
                         f"{available} CUDA devices of this host")
    return [f"cuda:{r}" for r in range(num_devices)]


def _run_rank(fn, rank: int, args, results, cpu_threads: int,
              log_level: int) -> None:
    """A spawned rank: ``fn(rank, *args)``, its value (or the traceback)
    put on ``results``; logging at the parent's level."""
    logging.basicConfig(level=log_level)
    if cpu_threads:
        torch.set_num_threads(cpu_threads)
    try:
        results.put(("ok", rank, fn(rank, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put(("error", rank, traceback.format_exc()))
        raise


def spawn(fn: Callable, nprocs: int, args: Tuple = (),
          timeout: Optional[float] = None, cpu: bool = False) -> List[Any]:
    """Run ``fn(rank, store, *args)`` in ``nprocs`` processes started with
    ``spawn``; returns their values in rank order.  ``store`` is a
    ``file://`` init method of a fresh directory, removed at the end.
    ``fn`` must be importable and its value picklable (numpy, not
    tensors).  A rank that raises or dies, or a group still running after
    ``timeout`` seconds, stops every rank and raises here.  ``cpu``: the
    ranks share the host's cores (each takes its share of threads).  One
    rank runs in this process (no timeout)."""
    tmp = tempfile.mkdtemp(prefix="flexdm_ranks_")
    store = f"file://{os.path.join(tmp, 'store')}"
    if nprocs == 1:
        try:
            return [fn(0, store, *args)]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // nprocs) if cpu else 0
    level = logging.getLogger().getEffectiveLevel()
    procs = [ctx.Process(target=_run_rank,
                         args=(fn, r, (store,) + tuple(args), results,
                               threads, level))
             for r in range(nprocs)]
    values: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(values) < nprocs:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
            try:
                status, rank, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [values[r] for r in range(nprocs)]


def run_ranks(fn: Callable, args: Tuple, num_devices: int,
              model_parallel: int, device: str, devices=None,
              backend: Optional[str] = None) -> Any:
    """``fn(*args, grid=grid)`` on ``num_devices`` ranks in a grid of
    ``model_parallel`` model ranks: joined to the group ``torchrun``
    describes, or else spawned (one rank runs in this process), rank ``r``
    on ``devices[r]`` if given, else where :func:`rank_devices` puts it,
    under ``backend`` (default: :func:`default_backend`).  Returns rank
    0's value; None on the other ranks under ``torchrun``."""
    if under_torchrun():
        grid = from_env(model_parallel, device, backend)
        if grid.world_size != num_devices:
            teardown()
            raise ValueError(f"--num_devices {num_devices} but torchrun "
                             f"started {grid.world_size} ranks")
        try:
            value = fn(*args, grid=grid)
        finally:
            teardown()
        return value if grid.is_primary else None
    devices = rank_devices(num_devices, device, devices)
    return spawn(_grid_rank, len(devices),
                 (fn, args, model_parallel, devices,
                  backend or default_backend(devices[0])),
                 cpu=all(torch.device(d).type == "cpu" for d in devices))[0]


def _grid_rank(rank: int, store: str, fn: Callable, args: Tuple,
               model_parallel: int, devices: Sequence[str], backend: str):
    grid = init_grid(rank, len(devices), model_parallel, devices[rank],
                     backend, store)
    try:
        value = fn(*args, grid=grid)
    finally:
        teardown()
    return value if grid.is_primary else None


def _flax_path(name: str, shape: Tuple[int, ...]):
    """The flax keys and shape of a port parameter (as
    :func:`..convert.params_to_jax` maps it)."""
    *modules, leaf = name.split(".")
    if leaf == "weight":
        if len(shape) == 2:
            return modules + ["kernel"], tuple(reversed(shape))
        return modules + ["scale"], shape
    return modules + [leaf], shape


def _flax_spec(keys, shape, model_size: int) -> Tuple:
    """JAX's ``partition_spec`` on flax keys (mesh.py:161-197)."""
    if model_size <= 1 or not shape or not keys:
        return ()
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""

    def last_dim(prefix: int) -> Tuple:
        if shape[-1] % model_size:
            return ()
        return (None,) * prefix + (MODEL_AXIS,)

    if parent in _ROW_PARALLEL and leaf == "kernel":
        if len(shape) == 2 and shape[0] % model_size == 0:
            return (MODEL_AXIS, None)
        return ()
    if parent in _COLUMN_PARALLEL or parent.startswith("decoder_"):
        if leaf == "kernel" and len(shape) == 2:
            return last_dim(1)
        if leaf == "bias" and len(shape) == 1:
            return last_dim(0)
        return ()
    if leaf.startswith("input_") and len(shape) == 2:
        return last_dim(1)
    if parent.startswith("input_") and leaf == "kernel" and len(shape) == 2:
        return last_dim(1)
    return ()


def partition_spec(name: str, shape: Sequence[int],
                   model_size: int) -> Tuple:
    """The tensor-parallel spec of the port parameter ``name`` of
    ``shape``, in the port's layout: one entry per dimension, ``"model"``
    on the split one, ``()`` when the parameter stays whole.  A Dense
    ``weight`` is the transposed flax ``kernel``, so its spec is the
    kernel's reversed."""
    keys, flax_shape = _flax_path(name, tuple(shape))
    spec = _flax_spec(keys, flax_shape, model_size)
    if spec and keys[-1] == "kernel":
        spec = tuple(reversed(spec))
    return spec


def split_dim(spec: Tuple) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _check_heads(model: nn.Module, model_size: int) -> None:
    """A split attention must split whole heads."""
    from ..models.transformer import MultiHeadAttention

    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention) and \
                partition_spec(f"{name}.query.weight",
                               tuple(m.query.weight.shape), model_size) \
                and m.num_heads % model_size:
            raise ValueError(f"{name}: --model_parallel {model_size} must "
                             f"divide num_heads {m.num_heads}")


@torch.no_grad()
def shard_params(model: nn.Module, grid: Grid, optimizer=None) -> None:
    """Keep this rank's slice of every parameter :func:`partition_spec`
    splits (and of its Adam moments, if ``optimizer`` is given), in place,
    each marked with its :class:`~.layers.Split`.  Every rank must hold
    the whole, equal values first (a seeded init or a checkpoint)."""
    if grid.model_size == 1:
        return
    _check_heads(model, grid.model_size)
    index = ({id(p): i for i, p in enumerate(optimizer.params)}
             if optimizer is not None else {})
    for name, p in model.named_parameters():
        dim = split_dim(partition_spec(name, tuple(p.shape),
                                       grid.model_size))
        if dim is None:
            continue
        k = p.shape[dim] // grid.model_size

        def mine(t):
            return t.narrow(dim, grid.model_rank * k, k).clone()

        p.data = mine(p.data)
        p.tp_split = Split(grid.model_group, grid.model_rank, grid.model_size,
                        dim)
        if id(p) in index:
            i = index[id(p)]
            optimizer.mu[i] = mine(optimizer.mu[i])
            optimizer.nu[i] = mine(optimizer.nu[i])


@torch.no_grad()
def gather_tensors(params: Sequence[torch.Tensor],
                   tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``tensors`` (each shaped like its parameter in ``params``) whole:
    the slices of a split parameter's gathered over the model group (a
    collective of every model rank), the others as they are."""
    out = []
    for p, t in zip(params, tensors):
        split = split_of(p)
        if split is None:
            out.append(t)
            continue
        parts = [torch.empty_like(t) for _ in range(split.size)]
        dist.all_gather(parts, t.contiguous(), group=split.group)
        out.append(torch.cat(parts, split.dim))
    return out


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with every split parameter whole."""
    names, params = zip(*model.named_parameters())
    return dict(zip(names, gather_tensors(params, params)))
