"""The port's channel gather against the JAX package's MXU gather.

Inputs come from numpy seeds and go through ``gather_channels_mxu`` (its
Pallas kernels in interpret mode off-TPU) and through the port's
``gather_channels_kernel`` (its plain version on CPU tensors).  The gather
is an exact index on both sides, so the forward matches to rtol 1e-6 (the
tolerance of the JAX package's own tiled-gather test).  The VJP sums the
cotangents of duplicate columns in another order; the cotangent rows are
non-negative and sum to 1 over the columns, as CTC posterior gradients do,
so the sums stay below 1 and match to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops.gathers import gather_channels_mxu
from gtn_applications_tpu_torch.ops import gathers, semiring


def _inputs(B, T, C, S, seed, pad_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    # duplicates are the normal case: idx draws from C with replacement,
    # and a fraction of the columns is -1 padding
    idx = rng.integers(0, C, (B, S)).astype(np.int32)
    idx[rng.random((B, S)) < pad_frac] = -1
    g = rng.random((B, T, S)).astype(np.float32)
    return x, idx, g / g.sum(-1, keepdims=True)


@pytest.mark.parametrize(
    "shape",
    [(2, 7, 11, 13), (2, 50, 201, 5003)],  # 5003: over one TPU column tile
    ids=["small", "tiled_huge_s"],
)
def test_gather_matches_mxu(shape):
    x, idx, g = _inputs(*shape, seed=sum(shape))
    out_j, vjp = jax.vjp(lambda a: gather_channels_mxu(a, jnp.asarray(idx)),
                         jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    gathers.check_indices(torch.from_numpy(idx), shape[2])
    out_t = gathers.gather_channels_kernel(xt, torch.from_numpy(idx))
    out_t.backward(torch.from_numpy(g))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-6)
    padded = np.broadcast_to(idx[:, None, :] < 0, g.shape)
    assert np.all(out_t.detach().numpy()[padded] == 0.0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=0, atol=1e-6)


def test_gather_unbatched_and_index_check():
    x, idx, _ = _inputs(1, 5, 6, 9, seed=3)
    x0, idx0 = torch.from_numpy(x[0]), torch.from_numpy(idx[0])
    out = semiring.gather_channels(x0, idx0, batched=False)
    ref = gathers.gather_channels_plain(x0[None], idx0[None])[0]
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        gathers.check_indices(torch.tensor([[0, 6]]), 6)
    with pytest.raises(ValueError):
        gathers.check_indices(torch.tensor([[-2, 0]]), 6)


@pytest.mark.parametrize("S,C,plan", [
    (1, 80, ("staged", 32, 1, 10848)),
    (23, 33, ("staged", 32, 1, 7596)),  # C not a multiple of 32, odd: rows of C
    (44, 80, ("staged", 32, 2, 16868)),  # ASG's force-aligned shape
    (89, 80, ("staged", 32, 3, 23168)),  # the CTC headline
    (4096, 80, ("staged", 10, 8, 216572)),  # S > C: ten rows fit
    (5003, 201, ("staged", 8, 8, 227388)),  # eight dx rows hold eight warps' counts
    (16000, 80, ("global", 32, 1, 192324)),  # not one row fits beside the plan
    (100, 50000, ("global", 32, 1, 201204)),  # not one dx row either
])
def test_gather_bwd_plan(S, C, plan):
    """The backward kernel's route, frames a tile, rank warps and shared
    bytes: the plan (3 S + C + 1 ints) always; beside it F g rows (F S + 4
    floats) and F dx rows of C | 1 floats, the most F up to 32 that fit in
    227 KB, and a rank warp for each C counts the dx rows hold (at most 8
    and one a 32-state chunk); where not one row fits, route "global" with
    one rank warp; where the plan alone does not fit, refused."""
    assert gathers.gather_bwd_plan(S, C) == plan
    assert plan[3] <= 232448
    if plan[0] == "staged":
        assert plan[2] * C <= plan[1] * (C | 1)
    with pytest.raises(ValueError):
        gathers.gather_bwd_plan(20000, 80)


def _ascending_sums(g, idx, C):
    """dx[b, t, c]: g[b, t, s] added in float32 in ascending s over the s
    with idx[b, s] == c, from 0; indices outside [0, C) drop out."""
    B, T, S = g.shape
    dx = np.zeros((B, T, C), np.float32)
    for b in range(B):
        for s in range(S):
            c = idx[b, s]
            if 0 <= c < C:
                dx[b, :, c] = dx[b, :, c] + g[b, :, s]
    return dx


def _emulate_bwd(g_flat, base, B, T, S, idx, C):
    """``gather_channels_bwd`` on ``gather_bwd_plan``'s schedule, in numpy
    float32: g [B, T, S] lies at word ``base`` of ``g_flat`` (its offset mod
    4 is the copies' phase).  A block a (sample, tile): the labels (outside
    [0, C): -1); rank warp w of Wr takes chunks [w K / Wr, (w + 1) K / Wr)
    of the K 32-state chunks, 32 states a round (a state's rank is its
    channel's count so far in the warp and the lanes below it with its
    channel; the set's lowest lane adds the set); each warp's count its
    offset among the channel's, first the channels' exclusive scan, the
    order placed by each warp; the tile's run of nf S words copied at its
    offset mod 4 (a 4-byte head, 16-byte body, 4-byte tail; route "global"
    reads it in place); lane r sums frame t0 + r, each channel's states in
    order from 0.  Returns dx (NaN where never written) and the (head,
    body, tail) copies of every staged tile."""
    route, F, Wr, _ = gathers.gather_bwd_plan(S, C)
    dx = np.full((B, T, C), np.nan, np.float32)
    copies = []
    K = -(-S // 32)
    for b in range(B):
        lab = np.where((idx[b] >= 0) & (idx[b] < C), idx[b], -1)
        cnt = np.zeros((Wr, C), np.int64)
        rank = np.zeros(S, np.int64)
        runs = [(w * K // Wr, (w + 1) * K // Wr) for w in range(Wr)]
        for w, (k0, k1) in enumerate(runs):
            for s0 in range(32 * k0, min(32 * k1, S), 32):
                chunk = lab[s0:s0 + 32]
                base_count = {c: cnt[w, c] for c in set(chunk.tolist()) if c >= 0}
                for lane, c in enumerate(chunk.tolist()):
                    if c >= 0:
                        rank[s0 + lane] = base_count[c] + int(np.sum(chunk[:lane] == c))
                for c, n in base_count.items():
                    cnt[w, c] = n + int(np.sum(chunk == c))
        offset = np.cumsum(cnt, axis=0) - cnt  # each warp's among the channel's
        first = np.zeros(C + 1, np.int64)
        first[1:] = np.cumsum(cnt.sum(axis=0))
        order = np.full(S, -1)
        for w, (k0, k1) in enumerate(runs):
            for s in range(32 * k0, min(32 * k1, S)):
                if lab[s] >= 0:
                    order[first[lab[s]] + offset[w, lab[s]] + rank[s]] = s
        assert sorted(order[:first[C]].tolist()) == [s for s in range(S) if lab[s] >= 0]
        for t0 in range(0, T, F):
            nf = min(F, T - t0)
            g0 = base + (b * T + t0) * S
            m = nf * S
            if route == "staged":
                ph = g0 % 4
                gs = np.full(F * S + 4, np.nan, np.float32)
                head = min((4 - ph) % 4, m)
                body = (m - head) // 4
                assert (ph + head) % 4 == 0 and (g0 + head) % 4 == 0 or body == 0
                gs[ph:ph + head] = g_flat[g0:g0 + head]
                gs[ph + head:ph + head + 4 * body] = g_flat[g0 + head:g0 + head + 4 * body]
                gs[ph + head + 4 * body:ph + m] = g_flat[g0 + head + 4 * body:g0 + m]
                copies.append((head, body, m - head - 4 * body))
                rows = gs[ph:ph + m].reshape(nf, S)
            else:
                rows = g_flat[g0:g0 + m].reshape(nf, S)
            for c in range(C):
                acc = np.zeros(nf, np.float32)
                for i in range(first[c], first[c + 1]):
                    acc = acc + rows[:, order[i]]
                dx[b, t0:t0 + nf, c] = acc
    return dx, copies


def _bwd_case(name):
    """(B, T, S, C, idx, g, word offset of g) of an emulation case: rows
    of g non-negative and summing to 1, as CTC posteriors do."""
    rng = np.random.default_rng(len(name))
    B, T, S, C = {"mixed": (3, 37, 13, 11), "one_label": (2, 33, 21, 7),
                  "odd_offset_1": (2, 40, 13, 11), "odd_offset_3": (2, 40, 13, 11),
                  "even_s": (2, 70, 44, 80), "ten_rows": (1, 23, 4096, 80),
                  "global": (1, 3, 16000, 80)}[name]
    idx = rng.integers(0, C, (B, S)).astype(np.int32)
    idx[:, 0::2] = C - 1  # duplicates: every even state one channel, as blanks
    if name == "mixed":
        idx[0, :4] = [-1, C, C + 5, -3]  # padding and indices out of range
        idx[1, 5] = -1
    if name == "one_label":
        idx[:] = 4
    g = rng.random((B, T, S)).astype(np.float32)
    g /= g.sum(-1, keepdims=True)
    offset = int(name[-1]) if name.startswith("odd_offset") else 0
    return B, T, S, C, idx, g, offset


@pytest.mark.parametrize("name", ["mixed", "one_label", "odd_offset_1", "odd_offset_3",
                                  "even_s", "ten_rows", "global"])
def test_gather_bwd_emulation_is_an_ascending_sum(name):
    """The backward kernel's plan and tile, emulated in float32, is bitwise
    the ascending-s sum by label: duplicates, -1 padding, indices outside
    [0, C), every state on one label, runs starting at every offset mod 4
    (odd S: each row of a tile starts at another), a tile of ten rows
    (S = 4,096) and the global route (S = 16,000); within 1e-6 of the sum
    in float64 and of the VJP of JAX's ``gather_channels_mxu`` (its Pallas
    kernels in interpret mode)."""
    B, T, S, C, idx, g, offset = _bwd_case(name)
    g_flat = np.concatenate([np.zeros(offset, np.float32), g.reshape(-1)])
    got, copies = _emulate_bwd(g_flat, offset, B, T, S, idx, C)
    want = _ascending_sums(g, idx, C)
    assert np.array_equal(got, want)
    valid = (idx >= 0) & (idx < C)
    want64 = np.zeros((B, T, C))
    for b in range(B):
        for s in np.flatnonzero(valid[b]):
            want64[b, :, idx[b, s]] += g[b, :, s].astype(np.float64)
    np.testing.assert_allclose(got, want64, rtol=0, atol=1e-6)
    route, _, rank_warps, _ = gathers.gather_bwd_plan(S, C)
    assert route == ("global" if name == "global" else "staged")
    assert rank_warps == {"mixed": 1, "one_label": 1, "odd_offset_1": 1, "odd_offset_3": 1,
                          "even_s": 2, "ten_rows": 8, "global": 1}[name]
    if route == "staged":
        assert any(body for _, body, _ in copies)
        if offset or S % 2:
            assert any(head for head, _, _ in copies) and any(tail for _, _, tail in copies)
    if S * C <= 4096:
        _, vjp = jax.vjp(lambda a: gather_channels_mxu(a, jnp.asarray(idx)),
                         jnp.zeros((B, T, C), jnp.float32))
        (dx_j,) = vjp(jnp.asarray(g))
        np.testing.assert_allclose(got, np.asarray(dx_j), rtol=0, atol=1e-6)
        # the port's CPU route agrees with the kernel's sums
        plain = gathers.gather_channels_bwd_plain(
            torch.from_numpy(g), torch.from_numpy(np.where(valid, idx, -1)), C)
        np.testing.assert_allclose(plain.numpy(), got, rtol=0, atol=1e-6)


def test_gather_bwd_profile_copies_match_the_kernel_source():
    """Each copy ``scripts/profile_gather_bwd.py`` builds of ``csrc/gather.cu``
    (a part removed or changed, or ``clock64`` marks added) still finds
    every piece of source it changes exactly once, so the script runs on
    the card as it is."""
    from gtn_applications_tpu_torch.scripts import profile_gather_bwd as prof

    for name, subs in dict(prof.VARIANTS, clocks=prof.CLOCKS).items():
        src = prof.patched(name, subs)
        assert all(new in src for _, new in subs), name
