"""Chunks of plain rounds replayed as CUDA graphs.

The JAX package compiles each host-driven chunk of rounds (a
``lax.scan`` of ``chunk`` rounds under ``jit``) into one program a
shape.  Eager PyTorch launches every operation of every round from the
host instead: a padded round is about a hundred small operations, and
on a shared host their launches, not the card, set the round's time.
:func:`run` is the counterpart of that ``jit``: on a CUDA device it
captures ``chunk`` rounds once a shape into a CUDA graph kept on the
problem and replays it, so a chunk costs a handful of host calls; on
the CPU it runs the rounds as they are.  The kernels are PyTorch's own
and the arithmetic is unchanged: a replay gives the eager result bit for
bit.
"""

from __future__ import annotations

import torch


def _fill(buffers, scalars) -> None:
    for buf, (value, dt) in zip(buffers, scalars):
        buf.fill_(bool(value) if dt == torch.bool else float(value))


def _tensors(out):
    """The tensors of a chunk's result: a state NamedTuple, or a pair of
    a state and a count."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        state, extra = out
        return list(state) + [extra]
    return list(out)


def _rebuild(out, tensors):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        state = out[0]
        return type(state)(*tensors[:-1]), tensors[-1]
    return type(out)(*tensors)


def run(fn, problem, state, scalars, chunk: int, static=()):
    """``fn(problem, state, *scalars, *static, chunk)``, through a
    captured CUDA graph when ``problem`` lies on a CUDA device.

    ``scalars`` are ``(value, torch dtype)`` pairs, host scalars handed
    to ``fn`` as 0-dim tensors; their values may change between calls
    (a replay fills them in, with no copy from host memory).  ``static``
    values are baked into the graph and part of its key, as are
    ``chunk`` and the state's shapes and dtypes.  The result's tensors
    are fresh copies, never the graph's own buffers."""
    dev = problem.device
    if dev.type != "cuda":
        return fn(problem, state,
                  *(torch.as_tensor(v, dtype=dt, device=dev)
                    for v, dt in scalars),
                  *static, chunk)
    key = (fn, chunk, static,
           tuple((tuple(t.shape), t.dtype) for t in state))
    graphs = problem.graphs
    entry = graphs.get(key)
    if entry is None:
        entry = graphs[key] = _capture(fn, problem, state, scalars, chunk,
                                       static)
    graph, inputs, buffers, out = entry
    for dst, src in zip(inputs, state):
        dst.copy_(src)
    _fill(buffers, scalars)
    graph.replay()
    return _rebuild(out, [t.clone() for t in _tensors(out)])


def _capture(fn, problem, state, scalars, chunk, static):
    dev = problem.device
    inputs = type(state)(*(t.clone() for t in state))
    buffers = tuple(torch.zeros((), dtype=dt, device=dev)
                    for _, dt in scalars)
    _fill(buffers, scalars)
    # one eager round on a side stream first, so that nothing the first
    # use of an operation sets up lands in the capture
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(problem, inputs, *buffers, *static, 1)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(problem, inputs, *buffers, *static, chunk)
    return graph, inputs, buffers, out
