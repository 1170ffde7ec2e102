"""The in-kernel round trace: the port's three round kernels against the
JAX package's ``trace_kernel_round`` sites, run in interpret mode.

With tracing on, JAX's Pallas kernels print one line a round from inside
the kernel (``ops/pallas_fr.py``, ``ops/pallas_fr_big.py``,
``ops/pallas_ksparse.py``; on stdout through ``pl.debug_print``); the
port's wrappers print the rows their kernels log, and on the CPU the
plain versions print the same rows (on stderr through
``utils.trace.trace_kernel_round``).  The same NumPy-seeded inputs go
through both; each side's lines are parsed into integer rows and split
into instances by the rounds each ran (the change in its ``nits``), and
must be equal exactly, instance by instance and round by round.  The
rows the wrappers return through ``trace_rows=`` must equal the printed
ones.  The CUDA kernels' logs are held against the plain versions' rows
on the card by ``chip_smoke.py``.

JAX reads its debug flag when a kernel is traced, so its caches are
cleared before and after each traced call.  The batched FR kernel runs
with ``group=1, serial=1`` and a budget that is not a multiple of 4
(no unrolled rounds), so that it prints each instance's rounds
consecutively and no frozen round after done.
"""

import re
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu.ops.auction import KhoslaState as JKState
from sparse_linear_assignment_tpu.ops.fr_dense import fr_init as jfr_init
from sparse_linear_assignment_tpu.ops.pallas_fr import fr_chunk_pallas
from sparse_linear_assignment_tpu.ops.pallas_fr_big import (
    fr_big_chunk as jfr_big_chunk,
)
from sparse_linear_assignment_tpu.ops.pallas_ksparse import ksp_chunk_pallas
from sparse_linear_assignment_tpu.utils import trace as jtrace
from sparse_linear_assignment_tpu_torch.ops import (
    fr_big,
    fr_kernel,
    ksparse_kernel,
    round_log,
)
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (
    fr_init,
    weights_from_jax_state,
)
from sparse_linear_assignment_tpu_torch.utils import trace

torch.set_num_threads(1)

_NUM = r"(-?\d+)"
FR_LINE = re.compile(rf"^fr kernel g={_NUM} round: nits={_NUM} "
                     rf"mode={_NUM} card={_NUM} done={_NUM}$")
BIG_LINE = re.compile(rf"^fr big kernel round: nits={_NUM} mode={_NUM} "
                      rf"card={_NUM} done={_NUM}$")
KSP_LINE = re.compile(rf"^ksp kernel round: nits={_NUM} active={_NUM} "
                      rf"done={_NUM}$")


def parse(text, pattern):
    """Every line of ``text`` that ``pattern`` matches, as an int tuple."""
    out = []
    for line in text.splitlines():
        m = pattern.match(line.strip())
        if m:
            out.append(tuple(int(x) for x in m.groups()))
    return out


def split(rows, counts):
    """Consecutive rows split into instances of ``counts`` rows each."""
    assert len(rows) == sum(counts), (len(rows), counts)
    out, at = [], 0
    for c in counts:
        out.append(rows[at:at + c])
        at += c
    return out


@contextmanager
def jax_traced():
    jax.clear_caches()  # the flag takes effect when a kernel is traced
    jtrace.set_debug(True)
    try:
        yield
    finally:
        jtrace.set_debug(False)
        jax.clear_caches()  # drop the debug-build programs again


@contextmanager
def port_traced():
    trace.set_debug(True)
    try:
        yield
    finally:
        trace.set_debug(False)


def np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def nits_of(state):
    return np.asarray(state.nits).astype(np.int64).reshape(-1)


def as_rows(per_instance, rounds, width):
    """Per-instance row lists as a zero-padded ``[B, rounds, W]`` array."""
    out = np.zeros((len(per_instance), rounds, width), dtype=np.int32)
    for i, rows in enumerate(per_instance):
        if rows:
            out[i, :len(rows)] = rows
    return out


# ----------------------------------------------------------------------
# the batched FR kernel: fr_chunk_pallas against fr_chunk
# ----------------------------------------------------------------------
B, N = 3, 128


def fr_case():
    """Three 128² instances on the int32 lattice (scale N + 1), eps 1."""
    rng = np.random.default_rng(11)
    costs = rng.integers(1, 50, size=(B, N, N))
    values_t = np.swapaxes(-costs, 1, 2).astype(np.int32) * (N + 1)
    jv = jnp.asarray(values_t)
    js0 = jax.vmap(lambda v: jfr_init(v, np.int32(1)))(jv)
    return values_t, jv, js0


def fr_both(capfd, values_t, jv, js0, rounds):
    """One traced chunk on each side; returns the per-instance rows
    (JAX, port), the port's ``g`` fields and its ``trace_rows``."""
    capfd.readouterr()
    with jax_traced():
        want, _ = fr_chunk_pallas(jv, js0, rounds, interpret=True, group=1,
                                  serial=1)
        jax.block_until_ready(want)
    jout = capfd.readouterr().out
    ts0 = weights_from_jax_state(np_fields(js0), device="cpu")
    rows = torch.zeros((B, rounds, 4), dtype=torch.int32)
    with port_traced():
        got, _ = fr_kernel.fr_chunk(torch.from_numpy(values_t), ts0, rounds,
                                    trace_rows=rows)
    perr = capfd.readouterr().err
    counts = nits_of(want) - nits_of(js0)
    np.testing.assert_array_equal(got.nits.numpy(), np.asarray(want.nits))
    jrows = split([r[1:] for r in parse(jout, FR_LINE)], counts)
    plines = parse(perr, FR_LINE)
    prows = split([r[1:] for r in plines], counts)
    gs = split([r[0] for r in plines], counts)
    return jrows, prows, gs, rows, want


def test_fr_kernel_trace_equals_jax_to_done(capfd):
    values_t, jv, js0 = fr_case()
    jrows, prows, gs, rows, want = fr_both(capfd, values_t, jv, js0, 301)
    assert prows == jrows
    for i, g in enumerate(gs):
        assert g == [i] * len(g)  # g is the instance's index in the batch
    np.testing.assert_array_equal(rows.numpy(), as_rows(prows, 301, 4))
    done = np.asarray(want.done)
    assert done.any()
    for inst, fin in zip(prows, done):
        assert all(r[3] == 0 for r in inst[:-1])
        if fin:  # the last row is the done round: a full matching
            assert inst[-1][3] == 1 and inst[-1][2] == N
        else:  # the budget ran out first
            assert len(inst) == 301 and inst[-1][3] == 0
        modes = [r[1] for r in inst]
        assert any(a != b for a, b in zip(modes, modes[1:]))  # a flip
        assert [r[0] for r in inst] == list(range(1, len(inst) + 1))


def test_fr_kernel_trace_equals_jax_at_a_budget_stop(capfd):
    """A 37-round budget stops every live instance short of done; an
    instance that enters done prints nothing."""
    values_t, jv, js0 = fr_case()
    js0 = js0._replace(done=js0.done.at[B - 1].set(True))
    jrows, prows, _, rows, want = fr_both(capfd, values_t, jv, js0, 37)
    assert prows == jrows
    assert [len(r) for r in prows] == [37, 37, 0]
    assert not bool(np.asarray(want.done)[:2].any())
    assert all(r[3] == 0 for inst in prows for r in inst)
    np.testing.assert_array_equal(rows.numpy(), as_rows(prows, 37, 4))


# ----------------------------------------------------------------------
# the big-single kernel: fr_big_chunk (JAX, interpret) against the port's
# ----------------------------------------------------------------------
def test_fr_big_kernel_trace_equals_jax(capfd):
    """A 40-round budget stop, then the continuation to done."""
    n = 256
    rng = np.random.default_rng(12)
    costs = rng.integers(1, 50, size=(n, n)).astype(np.float32)
    values_t = np.ascontiguousarray(-costs.T)
    eps = np.float32(1.0 / (n + 1))
    jv = jnp.asarray(values_t)
    want = jfr_init(jv, eps)
    tv = torch.from_numpy(values_t)[None]
    got = fr_init(tv, eps)
    jall, pall = [], []
    for rounds in (40, 2001):
        capfd.readouterr()
        before = int(want.nits)
        with jax_traced():
            want, _ = jfr_big_chunk(jv, want, rounds, bm=64, interpret=True)
            jax.block_until_ready(want)
        jrows = parse(capfd.readouterr().out, BIG_LINE)
        rows = torch.zeros((1, rounds, 4), dtype=torch.int32)
        with port_traced():
            got, _ = fr_big.fr_big_chunk(tv, got, rounds, trace_rows=rows)
        prows = parse(capfd.readouterr().err, BIG_LINE)
        assert len(jrows) == int(want.nits) - before
        assert prows == jrows
        np.testing.assert_array_equal(rows.numpy(),
                                      as_rows([prows], rounds, 4))
        jall += jrows
        pall += prows
    assert len(jall) > 40 and jall[39][3] == 0
    assert bool(want.done) and pall[-1][3] == 1 and pall[-1][2] == n
    modes = [r[1] for r in pall]
    assert any(a != b for a, b in zip(modes, modes[1:]))


# ----------------------------------------------------------------------
# the sparse kernel: ksp_chunk_pallas against ksp_chunk
# ----------------------------------------------------------------------
KB, KN, KM, KK = 4, 16, 32, 4
INFEASIBLE = 2


def ksp_case():
    """A staged ``gen_batch_ksparse`` plane, padded to the JAX kernel's
    128 lanes; instance 2 is infeasible (every person's only arc is
    object 5), so it ends on the drop rule."""
    cols, vals = port.generators.gen_batch_ksparse(3, KB, KN, KM, KK,
                                                   min_value=1.0,
                                                   range_width=4.0)
    cols[INFEASIBLE] = -1
    cols[INFEASIBLE, :, 0] = 5
    st = port.stage_batch_sparse(cols, vals, KM, eps=0.5, device="cpu")
    plane = st.values_nm.numpy()
    plane = np.pad(plane, ((0, 0), (0, 0), (0, 128 - plane.shape[2])),
                   constant_values=-np.inf)
    return plane, np.float32(st.eps_val), st.thresholds.numpy()


def test_ksp_kernel_trace_equals_jax(capfd):
    """Two 64-round chunks (the kernel route's budget) and a third to
    the end: the infeasible instance's lines end on drops."""
    plane, eps, thr = ksp_case()
    want = JKState(
        prices=jnp.zeros((KB, 128), jnp.float32),
        p2o=jnp.full((KB, KN), jnp.int32(port.UNASSIGNED)),
        o2p=jnp.full((KB, 128), jnp.int32(port.UNASSIGNED)),
        dropped=jnp.zeros((KB, KN), bool),
        nits=jnp.zeros((KB,), jnp.int32),
    )
    tv, tt = torch.from_numpy(plane), torch.from_numpy(thr)
    got = ksparse_kernel.khosla_init(tv)
    per_j = [[] for _ in range(KB)]
    per_p = [[] for _ in range(KB)]
    for rounds in (64, 64, 301):
        capfd.readouterr()
        before = nits_of(want)
        with jax_traced():
            want = ksp_chunk_pallas(jnp.asarray(plane), want, eps,
                                    jnp.asarray(thr), rounds,
                                    interpret=True)
            jax.block_until_ready(want)
        jout = capfd.readouterr().out
        rows = torch.zeros((KB, rounds, 3), dtype=torch.int32)
        with port_traced():
            got = ksparse_kernel.ksp_chunk(tv, got, eps, tt, rounds,
                                           trace_rows=rows)
        perr = capfd.readouterr().err
        counts = nits_of(want) - before
        np.testing.assert_array_equal(got.nits.numpy(),
                                      np.asarray(want.nits))
        jrows = split(parse(jout, KSP_LINE), counts)
        prows = split(parse(perr, KSP_LINE), counts)
        assert prows == jrows
        np.testing.assert_array_equal(rows.numpy(),
                                      as_rows(prows, rounds, 3))
        for i in range(KB):
            per_j[i] += jrows[i]
            per_p[i] += prows[i]
    assert per_p == per_j
    dropped = np.asarray(want.dropped)
    assert int(dropped[INFEASIBLE].sum()) == KN - 1
    bad = per_p[INFEASIBLE]
    assert len(bad) > 64 and bad[-1][1:] == (0, 1)
    assert all(r[1:] == (1, 0) for r in bad[:-1])
    for i in range(KB):
        assert per_p[i][-1][1:] == (0, 1)  # every instance ends done


# ----------------------------------------------------------------------
# tracing off, and the log written in pieces
# ----------------------------------------------------------------------
def test_tracing_off_prints_and_logs_nothing(capfd, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a round log was built with tracing off")

    monkeypatch.setattr(round_log, "plain_rows", forbidden)
    monkeypatch.setattr(round_log, "emit", forbidden)
    assert not trace.is_enabled()
    values_t, _, js0 = fr_case()
    tv = torch.from_numpy(values_t)
    ts0 = weights_from_jax_state(np_fields(js0), device="cpu")
    fr_kernel.fr_chunk(tv, ts0, 5)
    big = tv[:1].to(torch.float32)
    fr_big.fr_big_chunk(big, fr_init(big, 1.0), 5)
    plane, eps, thr = ksp_case()
    kv = torch.from_numpy(plane)
    ksparse_kernel.ksp_chunk(kv, ksparse_kernel.khosla_init(kv), eps,
                             torch.from_numpy(thr), 5)
    out, err = capfd.readouterr()
    assert out == "" and err == ""


def test_log_in_pieces_prints_what_one_launch_prints(capfd, monkeypatch):
    """``launch_traced`` over a log cut into pieces of rounds prints the
    same lines and leaves the same state as one launch."""
    values_t, _, js0 = fr_case()
    tv = torch.from_numpy(values_t)
    ts0 = weights_from_jax_state(np_fields(js0), device="cpu")

    def launch(s, r, log):
        # stands in for a kernel launch: it fills the log, prints nothing
        trace.set_debug(False)
        try:
            return fr_kernel.fr_chunk_reference(tv, s, r, trace_rows=log)[0]
        finally:
            trace.set_debug(True)

    def run():
        capfd.readouterr()
        with port_traced():
            out = round_log.launch_traced(
                launch, ts0, 90, None, round_log.FR_FORMAT, B, 4, tv.device,
                lambda s: s.nits)
        return out, capfd.readouterr().err

    whole, whole_err = run()
    monkeypatch.setattr(round_log, "MAX_LOG_BYTES", B * 4 * 4 * 30)
    pieces, pieces_err = run()  # three launches of 30 rounds
    assert pieces_err == whole_err and len(parse(whole_err, FR_LINE)) > 90
    for a, b in zip(pieces, whole):
        assert torch.equal(a, b)
