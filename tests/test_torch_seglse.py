"""The port's ``seg_lse`` (one sparse-lattice step) against the JAX package.

On CPU tensors the port's ``ops.seglse_pallas.seg_lse`` runs its plain
version (the CUDA pair runs on the card, where ``chip_smoke.py`` holds it
against this plain version).  It is held to JAX's Pallas ``seg_lse`` (in
interpret mode, as ``tests/test_seglse.py`` runs it) within rtol 1e-5 +
atol 1e-5 on values and rtol 1e-5 + atol 1e-6 on the VJP (dalpha, dw,
dem), with shared, per-sample and mixed batch dims and both kinds of
padding arcs (the port's ``src=0, dst=S-1, w=NEG`` and JAX's -1
endpoints), on data in which every destination is live.  Where states are
dead, the port masks them as JAX's plain ``segment_logsumexp`` does (the
Pallas kernel does not), so there it is held to that function's VJP.  The
arc index that the CUDA kernels walk is checked against the arcs it
groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import seglse_pallas as jax_seglse
from gtn_applications_tpu.ops import semiring as jax_semiring
from gtn_applications_tpu_torch.ops import seglse_pallas as slp
from gtn_applications_tpu_torch.ops.semiring import NEG

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _arcs(rng, rows, S, A, pad):
    """[rows, A] arcs in which every destination has an arc from a random
    source, then random arcs, then ``pad`` padding arcs."""
    n = A - pad
    src = rng.randint(0, S, (rows, n))
    dst = np.concatenate([np.tile(np.arange(S), (rows, 1)),
                          rng.randint(0, S, (rows, n - S))], axis=1)
    w = rng.randn(rows, n).astype(np.float32) * 0.5
    return src, dst, w


def _case(layout, padding, B=3, S=7, A=30, pad=4, seed=0):
    """alpha [B, S]; src, dst, w, em with the batch dims ``layout`` names
    (for src/dst, w, em: 's' shared, 'b' per sample)."""
    rng = np.random.RandomState(seed)
    rows = {"s": 1, "b": B}
    r_sd, r_w, r_em = (rows[c] for c in layout)
    src, dst, _ = _arcs(rng, r_sd, S, A, pad)
    w = rng.randn(r_w, A - pad).astype(np.float32) * 0.5
    em = rng.randn(r_em, A - pad).astype(np.float32)
    if padding == "port":  # wfst.compile.to_arc_table's padding arcs
        ps, pd, pw = 0, S - 1, NEG
    else:  # the JAX kernel's own -1 endpoints
        ps, pd, pw = -1, -1, NEG
    src = np.concatenate([src, np.full((r_sd, pad), ps)], 1).astype(np.int32)
    dst = np.concatenate([dst, np.full((r_sd, pad), pd)], 1).astype(np.int32)
    w = np.concatenate([w, np.full((r_w, pad), pw, np.float32)], 1)
    em = np.concatenate([em, np.zeros((r_em, pad), np.float32)], 1)
    alpha = rng.randn(B, S).astype(np.float32)
    g = rng.rand(B, S).astype(np.float32)
    return alpha, src, dst, w, em, g


def _port(alpha, src, dst, w, em, g):
    t = [torch.from_numpy(x) for x in (alpha, w, em)]
    for x in t:
        x.requires_grad_(True)
    out = slp.seg_lse(t[0], torch.from_numpy(src), torch.from_numpy(dst), t[1], t[2])
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("padding", ["port", "jax"])
@pytest.mark.parametrize("layout", ["sss", "bbb", "sbb", "bss", "sbs"])
def test_seg_lse_matches_pallas(layout, padding):
    alpha, src, dst, w, em, g = _case(layout, padding)
    out, grads = _port(alpha, src, dst, w, em, g)

    def f(alpha, w, em):
        return jax_seglse.seg_lse(alpha, jnp.asarray(src), jnp.asarray(dst), w, em)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (alpha, w, em)))
    j_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(j_out), **VALUE_TOL)
    for name, a, b in zip(("dalpha", "dw", "dem"), grads, j_grads):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)


def test_seg_lse_masks_dead_states_as_segment_logsumexp():
    """Dead sources, a destination reached only through dead arcs and one
    reached by no arc: values and VJP of JAX's masked plain step."""
    rng = np.random.RandomState(4)
    B, S, A = 2, 6, 16
    alpha = rng.randn(B, S).astype(np.float32)
    alpha[:, 1] = NEG
    src = rng.randint(0, S, (B, A)).astype(np.int32)
    dst = rng.randint(0, S - 2, (B, A)).astype(np.int32)
    src[:, :3], dst[:, :3] = 1, S - 2  # S-2: only from the dead state 1
    w = rng.randn(B, A).astype(np.float32)
    em = rng.randn(B, A).astype(np.float32)
    g = rng.rand(B, S).astype(np.float32)
    out, grads = _port(alpha, src, dst, w, em, g)

    def f(alpha, w, em):
        contrib = jax.vmap(lambda a, s: a[s])(alpha, jnp.asarray(src)) + w + em
        return jax.vmap(lambda c, d: jax_semiring.segment_logsumexp(c, d, S))(
            contrib, jnp.asarray(dst))

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (alpha, w, em)))
    j_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(j_out), **VALUE_TOL)
    assert (out[:, S - 2:] == NEG).all()
    for name, a, b in zip(("dalpha", "dw", "dem"), grads, j_grads):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)
    assert (grads[1][:, :3] == 0).all()


@pytest.mark.parametrize("rows", [1, 3])
def test_arc_index_groups_every_arc(rows):
    """The index the CUDA kernels walk: arcs sorted by destination (those
    without one last), each source's and each label's arcs listed once."""
    rng = np.random.RandomState(5)
    S, C, A = 9, 4, 40
    src = torch.from_numpy(rng.randint(-1, S, (rows, A)).astype(np.int32))
    dst = torch.from_numpy(rng.randint(-1, S + 1, (rows, A)).astype(np.int32))
    label = torch.from_numpy(rng.randint(0, C + 1, (rows, A)).astype(np.int32))
    idx = slp.arc_index(src, dst, S, label, C)
    for r in range(rows):
        order = idx.order[r].numpy()
        assert sorted(order) == list(range(A))
        d_sorted = dst[r].numpy()[order]
        ptr = idx.dptr[r].numpy()
        for s in range(S):
            assert (d_sorted[ptr[s]:ptr[s + 1]] == s).all()
        assert not ((d_sorted[ptr[S]:] >= 0) & (d_sorted[ptr[S]:] < S)).any()
        for field, ptr_, grp, n, ref in (
                ("src", idx.sptr, idx.sorder, S, src), ("label", idx.lptr, idx.lorder, C,
                                                         label)):
            sorted_ref = ref[r].numpy()[order]
            p, o = ptr_[r].numpy(), grp[r].numpy()
            listed = []
            for v in range(n):
                members = o[p[v]:p[v + 1]]
                assert (sorted_ref[members] == v).all(), field
                listed.extend(members.tolist())
            valid = np.nonzero((sorted_ref >= 0) & (sorted_ref < n))[0]
            assert sorted(listed) == valid.tolist(), field
            assert (getattr(idx, field)[r].numpy()
                    == np.where((sorted_ref >= 0) & (sorted_ref < n), sorted_ref, -1)).all()


def test_take_and_untake_are_inverse():
    rng = np.random.RandomState(6)
    order = torch.from_numpy(np.stack([rng.permutation(7) for _ in range(3)]))
    x = torch.from_numpy(rng.randn(3, 7).astype(np.float32))
    assert torch.equal(slp.untake(slp.take(x, order), order), x)
    shared = torch.from_numpy(rng.randn(1, 7).astype(np.float32))
    out = slp.take(shared, order)
    assert out.shape == (3, 7)
    assert torch.equal(slp.untake(out, order), shared.expand(3, 7))
