"""One train step captured as a CUDA graph and replayed T times a chunk:
the port's counterpart of the reference's jitted ``lax.scan`` runners
(``svax/train/loop.py: make_scan_runner``, ``make_minibatch_scan_runner``).

``ChunkGraph.run`` keeps static copies of the train state's tensors and of
the chunk's per-step inputs (a (T, …) stack each, such as the minibatch
indices), captures one call of the step on them, and replays that graph T
times; a device counter, advanced by the captured step, selects row t of
each stack. A launch argument or a Python scalar is frozen at capture, so
every scalar that changes from step to step is read from a table on the
device instead (``scalar``): the runner fills row t of each table on the
host, in the double arithmetic the eager step uses, once a chunk. The
train state's int leaves (the step, Adam's count) stay Python ints,
advanced by the chunk after it, so checkpoints and metrics keep their
meaning.

The Python launch counters of the kernels the step runs (``COUNTED``)
count wrapper calls, which a replay does not make: the increase that the
capture's one call makes is added once a replay.

``ChunkGraph(graphed=False)`` runs the same captured callable eagerly, T
calls a chunk without a graph: the CPU tests' check on what a replay does.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable

import torch

# The modules whose kernel launch counters a replay adds to.
COUNTED = ("combine", "decoder", "decoder_mlp", "estep")
# Eager warm-up calls on a side stream before a capture (PyTorch's rule for
# a captured backward), on a throw-away copy of the state.
WARMUP_CALLS = 3
# The smallest chunk a graph's static stacks hold (the entries' chunks are
# at most 1000 steps); a longer chunk recaptures with stacks twice as long.
# Stacks whose rows would pass STACK_BYTES at MIN_ROWS (injected ε at full
# width) hold the chunk's rows only.
MIN_ROWS = 1024
STACK_BYTES = 1 << 28

GRAPHED = "graphed"
CPU_EAGER = "eager (CPU tensors: a CUDA graph needs the card)"
SHARDED_EAGER = ("eager (sharded step: its gloo all-reduces are host calls, "
                 "which a CUDA graph cannot hold)")
KERNEL_CHUNK = "eager (a whole-step kernel: one launch a chunk already)"


ASKED_EAGER = "eager (asked for: graph=False, an entry's --no-graph)"


def route(device, sharded: bool = False, graph: bool | str | None = None) -> str:
    """How a per-step runner runs its chunks on ``device``: ``GRAPHED``
    (the default on CUDA), or eager with the reason — CPU tensors, a
    sharded step, or an explicit ``graph=False``. The entries print it."""
    if graph is False:
        return ASKED_EAGER
    if torch.device(device).type != "cuda":
        return CPU_EAGER
    if sharded:
        return SHARDED_EAGER
    return GRAPHED


class Tick(int):
    """An int leaf of a train state as a captured step sees it: its value at
    the chunk's start, tagged with its place ``path`` in the state, so that
    ``scalar`` can fill a table that follows it step by step."""

    path: int

    def __new__(cls, value: int, path: int):
        obj = int.__new__(cls, value)
        obj.path = path
        return obj


class Tables:
    """The per-step scalar tables of one graph: for each (name, dtype) a
    (rows,) tensor whose row t is ``fn(int_t)``, ``int_t`` being the int
    leaf it follows at step t of the chunk, and the step counter ``ctr``
    that the captured step advances."""

    def __init__(self, rows: int, device):
        self.rows = rows
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)
        self.entries: dict = {}  # (name, dtype) → (fn, path, table)
        self.start: dict[int, int] = {}  # the chunk's int leaves by path
        self.t_steps = 0

    def load(self, start: dict[int, int], t_steps: int) -> None:
        """Fill every table for a chunk of ``t_steps`` starting at ``start``."""
        self.start, self.t_steps = start, t_steps
        for fn, path, table in self.entries.values():
            self._fill(fn, path, table)

    def _fill(self, fn, path: int, table: torch.Tensor) -> None:
        base = self.start[path]
        host = torch.tensor([float(fn(base + t)) for t in range(self.t_steps)],
                            dtype=torch.float64).to(table.dtype)
        if table.is_cuda:
            host = host.pin_memory()
        table[:self.t_steps].copy_(host, non_blocking=table.is_cuda)

    def row(self, name: str, fn: Callable, at, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype)
        if key not in self.entries:
            if not isinstance(at, Tick):
                raise ValueError(f"per-step scalar {name!r}: a captured step reads it from "
                                 "an int leaf of the train state, given as it is")
            table = torch.zeros(self.rows, dtype=like.dtype, device=like.device)
            self.entries[key] = (fn, at.path, table)
            self._fill(fn, at.path, table)
        return self.entries[key][2].index_select(0, self.ctr).squeeze(0)


_active: Tables | None = None


def scalar(name: str, fn: Callable, at, like: torch.Tensor):
    """A per-step scalar of a train step: ``fn(at)``, a Python float computed
    as the eager step computes it, ``at`` being an int leaf of the train
    state (its step or Adam's count). Inside ``ChunkGraph``'s step it is
    instead row t of a device table of ``fn`` over the chunk's steps, a
    0-dim tensor of ``like``'s dtype and device: the same value, rounded
    once to that dtype as the eager step's Python scalar is."""
    if _active is None:
        return fn(at)
    return _active.row(name, fn, at, like)


def divide(tensors: list, name: str, fn: Callable, at, like: torch.Tensor) -> list:
    """``torch._foreach_div(tensors, fn(at))`` by a per-step scalar, as the
    eager step divides. Inside ``ChunkGraph``'s step the divisor is a table
    row, and the quotient rounds as the eager division by a Python scalar
    rounds on that device: on CUDA PyTorch multiplies by the reciprocal
    taken in double and rounded to the tensors' dtype (so the table holds
    1 / fn), on the CPU it divides (the table holds fn)."""
    if _active is None:
        return torch._foreach_div(tensors, fn(at))
    if like.is_cuda:
        inv = _active.row(f"{name}_reciprocal", lambda c: 1.0 / fn(c), at, like)
        return torch._foreach_mul(tensors, inv)
    return torch._foreach_div(tensors, _active.row(name, fn, at, like))


def step_size(rho, step, like: torch.Tensor):
    """CVI's (ρ_t, 1 − ρ_t) at ``step`` for a constant ρ or a schedule
    ``rho(step)``: Python floats, or table rows inside a captured step
    (``1 − ρ_t`` taken in double on the host, as the eager update's
    ``(1.0 - rho)``)."""
    if not callable(rho):
        return float(rho), 1.0 - float(rho)
    return (scalar("rho", lambda s: float(rho(s)), step, like),
            scalar("one_minus_rho", lambda s: 1.0 - float(rho(s)), step, like))


# ---------------------------------------------------------- train states


def flatten(tree) -> tuple[list, object]:
    """The leaves of a train state (NamedTuples, tuples, lists and dicts of
    tensors, ints and constants), in order, and its structure."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [flatten(tree[k]) for k in keys]
        return [v for p in parts for v in p[0]], (dict, keys, [p[1] for p in parts])
    if isinstance(tree, (tuple, list)):
        parts = [flatten(v) for v in tree]
        return [v for p in parts for v in p[0]], (type(tree), None, [p[1] for p in parts])
    return [tree], None


def unflatten(spec, leaves: list):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, kids = s
        vals = [build(k) for k in kids]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind in (tuple, list):
            return kind(vals)
        return kind(*vals)  # a NamedTuple

    return build(spec)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


# ------------------------------------------------------- launch counters


def launch_counts() -> dict:
    """Every kernel launch counter of ``COUNTED``: the ints named
    ``*launches*`` and the dicts named ``*_paths``, by (module, name)."""
    out = {}
    for mod in COUNTED:
        m = importlib.import_module(f"svax_torch.ops.{mod}")
        for name, v in vars(m).items():
            if ("launches" in name and _is_int(v)) or (name.endswith("_paths")
                                                       and isinstance(v, dict)):
                out[(mod, name)] = dict(v) if isinstance(v, dict) else v
    return out


def count_increase(before: dict, after: dict) -> dict:
    """What the counters rose by from ``before`` to ``after``."""
    inc = {}
    for key, v in after.items():
        if isinstance(v, dict):
            old = before[key]
            inc[key] = {p: n - old.get(p, 0) for p, n in v.items() if n != old.get(p, 0)}
        elif v != before[key]:
            inc[key] = v - before[key]
    return inc


def restore_counts(saved: dict) -> None:
    for (mod, name), v in saved.items():
        m = importlib.import_module(f"svax_torch.ops.{mod}")
        if isinstance(v, dict):
            getattr(m, name).clear()
            getattr(m, name).update(v)
        else:
            setattr(m, name, v)


def add_counts(inc: dict, times: int) -> None:
    """Add ``times`` × each increase to the counters (a chunk's replays)."""
    for (mod, name), v in inc.items():
        m = importlib.import_module(f"svax_torch.ops.{mod}")
        if isinstance(v, dict):
            paths = getattr(m, name)
            for p, n in v.items():
                paths[p] = paths.get(p, 0) + n * times
        else:
            setattr(m, name, getattr(m, name) + v * times)


# ------------------------------------------------------------ the engine


class ChunkGraph:
    """Chunks of one train step: ``run(state, t_steps, inputs, call, key,
    generator, word)`` → (state, metrics), the metrics (T,) tensors.

    ``call(state, rows, generator, word) → (state, metrics)`` is one step:
    ``rows`` holds row t of each of the chunk's (T, …) ``inputs`` (a
    name → tensor dict; None entries are left out), ``generator`` draws the
    step's noise, and ``word`` is the int64 device word {seed, step} that
    the combine kernels key their Philox stream on (None when the runner
    passes no ``word``=(seed, first step)). The captured step advances the
    counter and the word's step.

    ``key`` names what the graph froze beyond the state's and the inputs'
    shapes and dtypes, the generator and whether a word is passed (x's
    storage and shape, the batch): a change recaptures, as does a chunk
    longer than the stacks.
    ``graphed`` True captures and replays (CUDA); False runs ``call`` T
    times a chunk without a graph. A capture or replay that fails raises.

    Attributes read by the measurements: ``captures``, ``capture_seconds``
    (the last capture's, warm-up included) and ``pool_bytes`` (the device
    memory the last capture reserved)."""

    def __init__(self, graphed: bool = True):
        self.graphed = graphed
        self.frozen = None
        self.graph = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def _key(self, state_leaves, spec, inputs, key, word, generator) -> tuple:
        shapes = tuple((tuple(v.shape), v.dtype, v.device) if torch.is_tensor(v)
                       else "int" if _is_int(v) else ("constant", v) for v in state_leaves)
        ins = tuple((n, tuple(v.shape[1:]), v.dtype) for n, v in inputs.items())
        # A graph draws from the generator it registered.
        return (spec, shapes, ins, key, word is None, id(generator))

    def _body(self, generator):
        """One step on the static buffers: the callable a graph captures."""
        global _active
        t = self.tables
        rows = {n: b.index_select(0, t.ctr).squeeze(0) for n, b in self.stacks.items()}
        _active = t
        try:
            new, mets = self.call(self.view, rows, generator, self.word)
        finally:
            _active = None
        leaves, spec = flatten(new)
        if spec != self.spec:
            raise ValueError("the step returned a state of another structure")
        with torch.no_grad():
            torch._foreach_copy_(self.static, [leaves[i] for i in self.tensor_at])
            for name, v in mets.items():
                v = v.detach()
                if name not in self.out:
                    self.out[name] = torch.zeros((t.rows, *v.shape), dtype=v.dtype,
                                                 device=v.device)
                self.out[name].index_copy_(0, t.ctr, v[None])
            t.ctr.add_(1)
            if self.word is not None:
                self.word[1:].add_(1)
        return {i: int(leaves[i]) - int(self.view_leaves[i]) for i in self.int_at}

    def _set_deltas(self, deltas: dict) -> None:
        """Keep what one step adds to each int leaf; a table's int must
        advance by one a step."""
        for name, (_, path, _) in self.tables.entries.items():
            if deltas[path] != 1:
                raise ValueError(f"per-step scalar {name[0]!r} follows an int that "
                                 f"advances by {deltas[path]} a step")
        self.deltas = deltas

    def _load(self, state_leaves, inputs, t_steps, word) -> None:
        torch._foreach_copy_(self.static, [state_leaves[i] for i in self.tensor_at])
        for name, v in inputs.items():
            self.stacks[name][:t_steps].copy_(v[:t_steps])
        self.tables.load({i: int(state_leaves[i]) for i in self.int_at}, t_steps)
        self.tables.ctr.zero_()
        if self.word is not None:
            seed = word[0] & 0xFFFFFFFFFFFFFFFF
            self.word[0].fill_(seed - (1 << 64) if seed >= 1 << 63 else seed)
            self.word[1].fill_(word[1])

    def _build(self, state_leaves, spec, inputs, t_steps, call, word, generator, frozen):
        self.graph = None
        row_bytes = sum(v[0].numel() * v.element_size() for v in inputs.values())
        floor = MIN_ROWS if row_bytes * MIN_ROWS <= STACK_BYTES else 0
        rows = max(t_steps, floor, 2 * self.tables.rows if self.frozen == frozen else 0)
        self.frozen = frozen
        self.call, self.spec = call, spec
        self.tensor_at = [i for i, v in enumerate(state_leaves) if torch.is_tensor(v)]
        self.int_at = [i for i, v in enumerate(state_leaves) if _is_int(v)]
        self.static = [state_leaves[i].clone() for i in self.tensor_at]
        view = list(state_leaves)
        for j, i in enumerate(self.tensor_at):
            view[i] = self.static[j]
        for i in self.int_at:
            view[i] = Tick(state_leaves[i], i)
        self.view_leaves = view
        self.view = unflatten(spec, view)
        device = self.static[0].device
        self.stacks = {n: torch.zeros((rows, *v.shape[1:]), dtype=v.dtype, device=v.device)
                       for n, v in inputs.items()}
        self.tables = Tables(rows, device)
        self.word = None if word is None else torch.zeros(2, dtype=torch.int64,
                                                          device=device)
        self.out = {}
        self._load(state_leaves, inputs, t_steps, word)
        if not self.graphed:
            self.deltas = None
            self.increase = None
            return
        t0 = time.perf_counter()
        before = launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        scratch = torch.Generator(device=device).manual_seed(0)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.tables.ctr.zero_()  # row 0: the rows past the chunk are not filled
                self._body(scratch)
        torch.cuda.current_stream(device).wait_stream(side)
        self._load(state_leaves, inputs, t_steps, word)
        warm = launch_counts()
        graph = torch.cuda.CUDAGraph()
        if generator is not None and hasattr(graph, "register_generator_state"):
            graph.register_generator_state(generator)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as the capture's own set-up does, so that the
        reserved = torch.cuda.memory_reserved(device)  # pool's growth is counted
        with torch.cuda.graph(graph):
            self._set_deltas(self._body(generator))
        torch.cuda.synchronize(device)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.increase = count_increase(warm, launch_counts())
        restore_counts(before)
        self.graph = graph
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0

    def run(self, state, t_steps: int, inputs: dict, call: Callable, key=(),
            generator: torch.Generator | None = None, word: tuple[int, int] | None = None):
        state_leaves, spec = flatten(state)
        inputs = {n: v for n, v in inputs.items() if v is not None}
        frozen = self._key(state_leaves, spec, inputs, key, word, generator)
        if (self.frozen != frozen or t_steps > self.tables.rows
                or (self.graphed and self.graph is None)):
            self._build(state_leaves, spec, inputs, t_steps, call, word, generator, frozen)
        else:
            self._load(state_leaves, inputs, t_steps, word)
        if self.graphed:
            for _ in range(t_steps):
                self.graph.replay()
            add_counts(self.increase, t_steps)
        else:
            for _ in range(t_steps):
                deltas = self._body(generator)
                if self.deltas is None:
                    self._set_deltas(deltas)
        leaves = list(state_leaves)
        fresh = [torch.empty_like(t) for t in self.static]
        torch._foreach_copy_(fresh, self.static)
        for j, i in enumerate(self.tensor_at):
            leaves[i] = fresh[j]
        for i in self.int_at:
            leaves[i] = state_leaves[i] + self.deltas[i] * t_steps
        mets = {name: buf[:t_steps].clone() for name, buf in self.out.items()}
        return unflatten(spec, leaves), mets
