"""Long-sequence CTC of the port against the JAX package.

The same seeded inputs go through ``lattice.ctc_forward_score`` of both
packages by each long-sequence route: ``chunked`` (the port's kernel
``Function`` a chunk of frames at a time, its plain versions here; JAX's
checkpointed two-level scan), ``assoc`` per frame and by chunk transfers
(plain torch against jnp) and ``auto`` at T = 4,097, which both route to
``chunked``.  Tolerances are JAX's own (``tests/test_assoc_scan.py``):
the chunked scores within rtol 1e-5, their gradients within rtol 1e-4 /
atol 1e-5; the associative forms within 1e-4, their gradients rtol 1e-3 /
atol 1e-4.

At T = 4,097, where |score| reaches 8,578, no float32 gradient keeps
those tolerances against the exact one: JAX's chunked scan itself lies up
to 3.2e-4 from JAX's scan run in float64 (its alphas round at steps of
1e-3).  There the port's gradients are held against that float64
gradient and must lie no farther from it than JAX's float32 ones do, by
the largest and by the mean error.

The chunk route is also held to the whole-T route and to JAX on the edge
cases of its chunk split (a length ending on a chunk boundary, length 1,
a sample ending in the first chunk, an empty target, a chunk longer than
T, T - 1 not a multiple of the chunk, S past one warp, infeasible
targets), its boundary carries piece by piece, its saved tensors against
the whole-T route's, and ``configs/synthetic/long_ctx_assoc.json`` trains
an epoch through the port's train.py and test.py on the CPU.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.criterions.common import pad_targets as jax_pad_targets
from gtn_applications_tpu.ops import lattice as jax_lattice
from gtn_applications_tpu_torch import test as test_mod
from gtn_applications_tpu_torch import train as train_mod
from gtn_applications_tpu_torch.criterions.common import pad_targets
from gtn_applications_tpu_torch.ops import gathers, lattice
from gtn_applications_tpu_torch.ops import lattice_pallas as lp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run thousands of small tensor ops
    (the epoch ~20 k), which several threads a worker only slow down when
    other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, C, target_lengths, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    # labels over 0..C-2 (blank C-1), with repeats so that some skips are off
    tgts = []
    for n in target_lengths:
        x = rng.randint(0, C - 1, size=n)
        x[1::3] = x[0::3][: len(x[1::3])]
        tgts.append([int(v) for v in x])
    return logits, tgts


def _jax_score_grad(logits, tgts, lens, impl, chunk=None, x64=False):
    """JAX's score and logit gradient; ``x64`` runs them in float64."""
    with jax.enable_x64(x64):
        targets, lengths = jax_pad_targets(tgts)

        def f(x):
            s = jax_lattice.ctc_forward_score(
                jax.nn.log_softmax(x, axis=2), targets, lengths, logits.shape[2] - 1,
                jnp.asarray(lens, jnp.int32), impl, chunk)
            return s.sum(), s

        x = jnp.asarray(logits, jnp.float64 if x64 else jnp.float32)
        (_, s), g = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
        return np.asarray(s), np.asarray(g)


def _port_score_grad(logits, tgts, lens, impl, chunk=None):
    x = torch.from_numpy(logits).requires_grad_(True)
    targets, lengths = pad_targets(tgts)
    s = lattice.ctc_forward_score(
        torch.log_softmax(x, dim=2), targets, lengths, logits.shape[2] - 1,
        torch.tensor(lens, dtype=torch.int32), impl, chunk)
    s.sum().backward()
    return s.detach(), x.grad


# T = 4,097: past the whole-T route's 4,096 frames, so "auto" is "chunked"
LONG = dict(B=4, T=4097, C=6, target_lengths=[5, 3, 0, 4], lens=[4097, 4000, 300, 129],
            seed=0)


def _long():
    logits, tgts = _inputs(LONG["B"], LONG["T"], LONG["C"], LONG["target_lengths"],
                           LONG["seed"])
    return logits, tgts, LONG["lens"]


@pytest.fixture(scope="module")
def long_exact():
    """JAX's scan of the long case in float64: the exact score and logit
    gradient to float32's eyes."""
    logits, tgts, lens = _long()
    return _jax_score_grad(logits.astype(np.float64), tgts, lens, "scan", x64=True)


@pytest.mark.parametrize("impl", ["chunked", "auto"])
def test_long_chunked_matches_jax(impl, long_exact):
    logits, tgts, lens = _long()
    s_j, g_j = _jax_score_grad(logits, tgts, lens, impl)
    s_t, g_t = _port_score_grad(logits, tgts, lens, impl)
    s_x, g_x = long_exact
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), s_x, rtol=1e-5)
    # float32 gradients at |score| ~ 8,600 (see the module's docstring)
    err_t, err_j = np.abs(g_t.numpy() - g_x), np.abs(g_j - g_x)
    assert err_t.max() <= err_j.max() and err_t.mean() <= err_j.mean(), (
        err_t.max(), err_j.max(), err_t.mean(), err_j.mean())


@pytest.mark.parametrize("chunk", [None, 512])
def test_long_assoc_matches_jax(chunk):
    """Both associative forms, per frame and by chunk transfers."""
    logits, tgts, lens = _long()
    s_j, g_j = _jax_score_grad(logits, tgts, lens, "assoc", chunk)
    s_t, g_t = _port_score_grad(logits, tgts, lens, "assoc", chunk)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-3, atol=1e-4)


# the chunk split's edge cases: (T, chunk, target lengths, input lengths);
# the first call holds frames [0, 1 + chunk), the others chunk frames
EDGE_CASES = {
    # lengths ending on the first and third call's last frame
    "boundary_end": (40, 8, [3, 4, 2, 5], [40, 9, 25, 17]),
    "length_one": (20, 6, [1, 0, 3], [1, 1, 20]),
    # one sample ends inside the first chunk while the others run to T
    "first_chunk_end": (33, 10, [2, 4, 3], [5, 33, 33]),
    # an empty target beside others, and a batch whose every target is empty
    "empty_target": (24, 5, [0, 3, 0], [24, 19, 7]),
    "all_empty": (24, 5, [0, 0], [24, 13]),
    "chunk_past_T": (20, 100, [3, 2], [20, 14]),
    # T - 1 = 29 frames after the first, not a multiple of 7
    "ragged_tail": (30, 7, [4, 2, 3], [30, 28, 23]),
    # S = 41 (past one warp: the block routes on the card) and S = 11
    "wide": (48, 16, [20, 17], [48, 45]),
    "narrow": (48, 16, [5, 4], [48, 31]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_chunk_edge_cases(case):
    """The chunk route (its plain versions) within JAX's tolerances of the
    whole-T route and of JAX's chunked scan: scores rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-5."""
    T, chunk, tl, lens = EDGE_CASES[case]
    logits, tgts = _inputs(len(tl), T, 9, tl, seed=len(case))
    s_w, g_w = _port_score_grad(logits, tgts, lens, "auto")
    s_c, g_c = _port_score_grad(logits, tgts, lens, "chunked", chunk)
    s_j, g_j = _jax_score_grad(logits, tgts, lens, "chunked", chunk)
    for s_r, g_r in ((s_w.numpy(), g_w.numpy()), (s_j, g_j)):
        np.testing.assert_allclose(s_c.numpy(), s_r, rtol=1e-5)
        np.testing.assert_allclose(g_c.numpy(), g_r, rtol=1e-4, atol=1e-5)


def test_chunk_infeasible_targets_match_jax():
    """Targets that need more frames than their samples have (tests/
    test_torch_ctc.py's INFEASIBLE, over three calls of 2 frames): the
    losses agree with JAX's chunked scan (NEG's 1e30 on the infeasible
    samples), and so do the gradients, which are 0 on those samples, as
    JAX's scan makes them, where the whole-T kernel route's are not."""
    tgts, lens = [[1, 1, 1, 1], [2, 2, 2], [0, 3]], [6, 4, 6]
    logits = np.random.RandomState(7).randn(3, 6, 5).astype(np.float32)
    s_j, g_j = _jax_score_grad(logits, tgts, lens, "chunked", 2)
    s_c, g_c = _port_score_grad(logits, tgts, lens, "chunked", 2)
    np.testing.assert_allclose(s_c.numpy(), s_j, rtol=1e-5)
    assert (s_c[:2] < -9e29).all()
    np.testing.assert_allclose(g_c.numpy(), g_j, rtol=1e-4, atol=1e-5)
    assert not g_c[:2].any() and g_c[2].abs().max() > 0.1


def _kernel_inputs(B=3, T=29, C=7, tl=(4, 0, 2), lens=(29, 11, 1), seed=5):
    logits, tgts = _inputs(B, T, C, list(tl), seed)
    targets, lengths = pad_targets(tgts)
    lp_t = torch.log_softmax(torch.from_numpy(logits), dim=2)
    labels, skip_ok = lattice.ctc_state_tables(targets, C - 1)
    start, accept = lattice.ctc_start_accept(lengths, labels.shape[1])
    return lp_t, labels, start, accept, skip_ok.to(torch.float32), \
        torch.tensor(lens, dtype=torch.int32)


def test_boundary_carries():
    """The plain versions' chunk options piece by piece:
    ``gather_channels_plain`` over a window is the slice's;
    ``ctc_alpha_plain`` from ``alpha_in`` runs from alpha_in less
    ``carry_shift(alpha_in)`` (bitwise the run from the shifted row) and
    gives the whole-T rows less that shift; ``ctc_grad_plain`` from a
    carried ``beta_in`` (lens relative to t0) gives the whole-T route's
    grad rows and beta carries bitwise with the whole-T score, and in the
    chunk mode (score None) the grad rows within rtol 1e-5 / atol 1e-6 (0
    on the infeasible sample, two labels in one frame); a sample with len
    <= t0 is frozen at its shifted alpha_in, emits zeros and passes beta_in
    through (shifted in the chunk mode)."""
    lp_t, labels, start, accept, skip, lens = _kernel_inputs()
    B, T, C = lp_t.shape
    em = gathers.gather_channels_plain(lp_t, labels)
    assert torch.equal(gathers.gather_channels_plain(lp_t, labels, 10, 7), em[:, 10:17])
    alpha = lp.ctc_alpha_plain(em, start, skip, lens)
    score = lp._final_score(alpha[:, -1], accept)
    g = torch.tensor([0.5, -1.0, 2.0])
    grad, beta0 = lp.ctc_grad_plain(em, alpha, accept, skip, lens, score, g, True)
    assert torch.equal(grad, lp.ctc_grad_plain(em, alpha, accept, skip, lens, score, g))
    for t0 in (1, 5, 12, 28):
        head = lp.ctc_alpha_plain(em[:, :t0], start, skip, lens)
        shift = lp.carry_shift(head[:, -1])
        tail = lp.ctc_alpha_plain(em[:, t0:], None, skip, lens - t0, head[:, -1])
        assert torch.equal(tail, lp.ctc_alpha_plain(em[:, t0:], None, skip, lens - t0,
                                                    head[:, -1] - shift[:, None]))
        torch.testing.assert_close(tail + shift[:, None, None], alpha[:, t0:], rtol=1e-6,
                                   atol=1e-4)
        g_tail, beta = lp.ctc_grad_plain(em[:, t0:], alpha[:, t0:], accept, skip, lens - t0,
                                         score, g, True)
        g_head, beta_h = lp.ctc_grad_plain(em[:, :t0], alpha[:, :t0], beta, skip, lens,
                                           score, g, True)
        assert torch.equal(torch.cat([g_head, g_tail], 1), grad)
        assert torch.equal(beta_h, beta0)
        g_tail, beta = lp.ctc_grad_plain(em[:, t0:], tail, accept, skip, lens - t0, None, g,
                                         True)
        g_head = lp.ctc_grad_plain(em[:, :t0], head, beta, skip, lens, None, g)
        g_chunks = torch.cat([g_head, g_tail], 1)
        torch.testing.assert_close(g_chunks[:2], grad[:2], rtol=1e-5, atol=1e-6)
        assert not g_chunks[2].any() and grad[2].any()
        dead = lens <= t0
        frozen = head[dead, -1:] - shift[dead, None, None]
        assert torch.equal(tail[dead], frozen.expand(-1, T - t0, -1))
        assert not g_tail[dead].any()
        assert torch.equal(beta[dead], accept[dead] - lp.carry_shift(accept[dead])[:, None])


@pytest.mark.parametrize("T, chunk, want", [
    (1, 4, [(0, 1)]), (5, 4, [(0, 5)]), (6, 4, [(0, 5), (5, 1)]),
    (30, 7, [(0, 8), (8, 7), (15, 7), (22, 7), (29, 1)]), (20, 100, [(0, 20)]),
])
def test_chunk_spans(T, chunk, want):
    """Frame 0 joins the first chunk's call; the others take ``chunk``
    frames, the last one short: JAX's split of frames 1..T-1."""
    assert lp.chunk_spans(T, chunk) == want
    with pytest.raises(ValueError):
        lp.chunk_spans(T, 0)


def _saved_bytes(fn, lp_t):
    """Bytes of the tensors autograd saves for the backward while ``fn``
    runs, those that share the input's storage excepted (the input is alive
    either way)."""
    seen = []

    def pack(t):
        if t.untyped_storage().data_ptr() != lp_t.untyped_storage().data_ptr():
            seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen)


def test_chunked_saved_tensors_bounded():
    """The port's twin of ``test_chunked_assoc_peak_memory_bounded``: at
    T = 1,024 the chunk route keeps the boundary alphas [T / chunk, B, S]
    where the whole-T route keeps the [B, T, S] trajectory."""
    B, T, C = 2, 1024, 6
    logits, tgts = _inputs(B, T, C, [4, 3], seed=4)
    targets, lengths = pad_targets(tgts)
    lp_t = torch.log_softmax(torch.from_numpy(logits), dim=2).requires_grad_(True)
    labels, skip_ok = lattice.ctc_state_tables(targets, C - 1)
    start, accept = lattice.ctc_start_accept(lengths, labels.shape[1])
    il = torch.full((B,), T, dtype=torch.int32)
    args = (lp_t, labels, start, accept, skip_ok, il)
    whole = _saved_bytes(lambda: lp.ctc_score_kernel(*args), lp_t)
    chunked = _saved_bytes(lambda: lp.ctc_score_chunked(*args, chunk=128), lp_t)
    assert whole >= B * T * labels.shape[1] * 4
    assert chunked * 8 <= whole, (chunked, whole)


def test_train_long_ctx_assoc(tmp_path, caplog):
    """One ``--disable_cuda`` epoch of the shipped
    ``configs/synthetic/long_ctx_assoc.json`` through the port's train.py
    and test.py, as JAX's ``test_train_ctc_assoc_impl`` does: the
    criterion is "assoc" with chunk 256, the lines are >= 4,096 frames,
    ``seq_parallel`` falls back to data-only with JAX's warning, the loss is
    finite and the checkpoint written.  ``num_samples`` is cut from 8 to 4
    (one batch of 4): the chunk transfers' host memory grows with B."""
    from gtn_applications_tpu_torch.datasets import synthetic_long

    with open(os.path.join(ROOT, "configs/synthetic/long_ctx_assoc.json")) as fid:
        config = json.load(fid)
    config["data"]["data_path"] = str(tmp_path)
    config["data"]["num_samples"] = 4
    config["optim"]["epochs"] = 1
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))

    _, pre, criterion, _, _ = train_mod.load_experiment(config)
    assert criterion.impl == "assoc" and criterion.chunk == 256
    ds = synthetic_long.Dataset(str(tmp_path), pre, split="train")
    assert min(w for (w, h), _ in ds.sample_sizes()) >= 4096

    argv = ["--config", str(cfg), "--checkpoint_path", str(tmp_path), "--disable_cuda"]
    with caplog.at_level(logging.WARNING):
        _, history = train_mod.train(train_mod.parse_args(argv))
    assert any("seq_parallel=4" in r.getMessage() for r in caplog.records)
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["val_loss"])
    assert os.path.exists(tmp_path / "model.checkpoint")
    meters = test_mod.run_test(test_mod.parse_args(argv))
    assert np.isfinite(meters.avg_loss)
