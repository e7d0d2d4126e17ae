"""The port's ``seg_max`` against the JAX package.

``seg_max_plain`` (what CPU tensors take) against JAX
``segmax_pallas.seg_max`` (its Pallas kernel in interpret mode off-TPU) on
the same numpy-seeded inputs: values bitwise, winning arcs exactly.  At
S = 2,048 the JAX kernel tiles the arcs by 256, so ~700 arcs span three
tiles; integer-valued inputs over few destinations tie exactly across
those tiles, where the kernel's strict ``>`` keeps the earlier tile's
(lowest) arc.  Fields are shared, per sample and mixed; padding arcs carry
-1 endpoints and NEG weights; half the states have no in-arcs.  The label
mode (one frame's emission row read by the arcs' labels) must equal the
per-arc mode on the gathered emissions.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
``seg_max_plain``; here that check is itself tested, with a plain stand-in
that reads the kernel's arc index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtn_applications_tpu.ops import segmax_pallas as jax_smp
from gtn_applications_tpu_torch.ops import segmax_pallas as smp
from gtn_applications_tpu_torch.ops.semiring import NEG

B, S, A, TILE = 2, 2048, 700, 256


def _inputs(layout, seed):
    """alpha [B, S], src/dst/w/em [Ba, A] (Ba per field as ``layout``
    says), integer-valued; arcs enter the first 64 states only; the last
    20 arcs are padding; a tenth of alpha is NEG."""
    rng = np.random.default_rng(seed)
    rows = {"shared": (1, 1, 1, 1), "per sample": (B, B, B, B),
            "mixed": (1, B, 1, B)}[layout]
    alpha = rng.integers(-3, 4, (B, S)).astype(np.float32)
    alpha[rng.random((B, S)) < 0.1] = NEG
    src = rng.integers(0, S, (rows[0], A)).astype(np.int32)
    dst = rng.integers(0, 64, (rows[1], A)).astype(np.int32)
    w = rng.integers(-2, 3, (rows[2], A)).astype(np.float32)
    em = rng.integers(-2, 3, (rows[3], A)).astype(np.float32)
    src[:, -20:], dst[:, -20:], w[:, -20:] = -1, -1, NEG
    return alpha, src, dst, w, em


@pytest.mark.parametrize("layout", ["shared", "per sample", "mixed"])
def test_seg_max_matches_jax_kernel(layout):
    alpha, src, dst, w, em = _inputs(layout, seed=len(layout))
    j_new, j_arc = jax_smp.seg_max(*(jnp.asarray(x) for x in (alpha, src, dst, w, em)))
    new, arc = smp.seg_max(*(torch.from_numpy(x) for x in (alpha, src, dst, w, em)))
    assert jax_smp._arc_tile(A, S) == TILE
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(arc.numpy(), np.asarray(j_arc))
    assert arc.dtype == torch.int32
    # dead destinations (no in-arcs) and states reached only from NEG
    assert (arc[:, 64:] == smp.BIG).all() and (new[:, 64:] == NEG).all()
    assert (arc[:, :64] < A - 20).all()
    # exact ties between arcs of different JAX tiles, won by the earlier one
    _, c = smp._arc_fields(torch.from_numpy(alpha), torch.from_numpy(src),
                           torch.from_numpy(dst), torch.from_numpy(w), torch.from_numpy(em),
                           None)
    dst_b = torch.from_numpy(dst).long().expand(B, A)
    tied_late = (c == new.gather(1, dst_b.clamp(min=0))) & (dst_b >= 0) & (
        torch.arange(A) // TILE > arc.long().gather(1, dst_b.clamp(min=0)) // TILE)
    assert int(tied_late.sum()) > 0


def test_seg_max_floor_and_padding():
    """A contribution at NEG never wins; a state reached only from NEG
    states stays NEG (float32 absorbs NEG + small); padding and invalid
    sources are dropped."""
    alpha = torch.tensor([[0.0, NEG, NEG]])
    src = torch.tensor([[1, 2, -1, 0, -1]], dtype=torch.int32)
    dst = torch.tensor([[1, 1, 2, 0, -1]], dtype=torch.int32)
    w = torch.tensor([[0.5, 3.0, 9.0, -1.0, NEG]])
    em = torch.zeros(1, 5)
    new, arc = smp.seg_max(alpha, src, dst, w, em)
    assert torch.equal(new, torch.tensor([[-1.0, NEG, NEG]]))
    assert arc.tolist() == [[3, smp.BIG, smp.BIG]]
    # JAX reads alpha 0 for a source of -1, so its arc 2 is dropped by its
    # destination alone
    dst_j = torch.tensor([[1, 1, -1, 0, -1]], dtype=torch.int32)
    j_new, j_arc = jax_smp.seg_max(*(jnp.asarray(x.numpy()) for x in (
        alpha, src, dst_j, w, em)))
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(arc.numpy(), np.asarray(j_arc))


@pytest.mark.parametrize("rows", [1, B])
def test_label_mode_matches_per_arc(rows):
    rng = np.random.default_rng(5 + rows)
    C = 7
    alpha, src, dst, w, _ = (torch.from_numpy(x) for x in _inputs("shared", 9))
    label = torch.from_numpy(rng.integers(-1, C + 2, (rows, A)).astype(np.int32))
    row = torch.from_numpy(rng.normal(size=(B, C)).astype(np.float32))
    lab = label.long().expand(B, A)
    ok = (lab >= 0) & (lab < C)
    gathered = torch.where(ok, row.gather(1, torch.where(ok, lab, 0)), 0.0)
    by_label = smp.seg_max(alpha, src, dst, w, row, label=label)
    per_arc = smp.seg_max(alpha, src, dst, w, gathered)
    assert torch.equal(by_label[0], per_arc[0]) and torch.equal(by_label[1], per_arc[1])


def _plain_stand_in(broken):
    """``seg_max_cuda``'s function from its own inputs: the arcs in the
    index's order (destinations recovered from ``dptr``), winning sorted
    positions mapped back to arc ids through ``order``."""
    def run(alpha, w_s, em, idx):
        rows, A_ = idx.order.shape
        pos = torch.arange(A_).expand(rows, A_).contiguous()
        dst_s = torch.searchsorted(idx.dptr[:, 1:].contiguous(), pos, right=True)
        new, arc_s = smp.seg_max_plain(alpha, idx.src, dst_s, w_s, em, idx.label)
        won = arc_s < smp.BIG
        arc = torch.where(won, idx.order.expand(alpha.shape[0], A_).gather(
            1, torch.where(won, arc_s, 0).long()), smp.BIG).to(torch.int32)
        if broken:
            live = won.nonzero()
            arc[tuple(live[len(live) // 2])] += 1
        return new, arc
    return run


@pytest.mark.parametrize("broken", [False, True])
def test_smoke_segmax_check_holds_arcs_exactly(monkeypatch, broken):
    """``chip_smoke.py``'s seg_max check with the plain version standing in
    for the kernel: it passes every case as it is and fails one winning
    arc moved."""
    import chip_smoke

    monkeypatch.setattr(smp, "seg_max_cuda", _plain_stand_in(broken))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cases = chip_smoke.segmax_cases(torch, "cpu", b=2)
    assert [c[0][0] for c in cases] == [
        "4-gram decode table", "4-gram integer ties", "per sample",
        "mixed batch dims", "padding and dead states"]
    assert cases[0][0][2:] == (35455, 12)  # the 4-gram decode table's A and C
    for i, (what, *inputs) in enumerate(cases):
        if broken:
            with pytest.raises(AssertionError, match="winning arcs"):
                chip_smoke.hold_segmax_kernel(torch, *inputs, what)
        else:
            assert chip_smoke.hold_segmax_kernel(
                torch, *inputs, what, need_ties=i == 1) == {"seg_max": 0.0}
