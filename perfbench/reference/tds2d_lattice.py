"""Plain PyTorch reference of the TDS2d recipes: the encoder, the
alignment lattice over a target's decompositions, SGD with global-norm
clipping, and the greedy decode's gap.

It follows Hannun et al., "Differentiable Weighted Finite-State
Transducers" (2020) and the reference recipes ``configs/iamdb/tds2d.json``
and ``configs/iamdb/word_decomps.json``, and imports nothing of the
measured program.  Everything runs in float32 with TF32 off unless the
caller turns TF32 on (the control).

The encoder is TDS2d, channel-first [B, C, H, W]: per group a strided
(kh, kw) convolution, ReLU, dropout, instance norm, then blocks of a
(kh, kw) convolution C -> C shared over the D depth planes and a two-layer
dense over the C*D channels, each with a residual and an instance norm
(statistics in one pass, E[x^2] - E[x]^2, over every spatial position);
the head flattens [B, W', C, H'] with C major.  Dropout is inverted and
draws each mask as ``torch.rand(shape, generator) >= p`` in the order the
layers apply it, so the same generator state gives the same masks.

Both criteria score one lattice: the sequences of frame labels that
collapse (runs merged, then blanks, the last channel, dropped) to a
decomposition of the target into pieces.  The same piece twice in a row
needs a blank between (no repeats).  CTC is the case of one piece per
unit; the word decompositions take the 1,000 wordpieces over graphemes.
Its states are each occurrence of a piece in the target and a blank
state at each position; the loss is -log of the lattice's total weight
under log-softmaxed emissions, over every frame of the padded batch,
divided by the target's length, averaged over the batch.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

NORM_EPS = 1e-5
NEG = -1e30
PIXEL_MEAN = 0.912
PIXEL_STD = 0.168
WIDTH_MULTIPLE = 16


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(model_cfg, input_size, output_size):
    """[(name, shape)] of TDS2d's parameters."""
    kh, kw = model_cfg["kernel_size"]
    depth = model_cfg["depth"]
    convs, norms, blocks = [], [], []
    c_in, h = 1, input_size
    for i, group in enumerate(model_cfg["tds_groups"]):
        c_out = depth * group["channels"]
        convs += [(f"convs.{i}.weight", (c_out, c_in, kh, kw)), (f"convs.{i}.bias", (c_out,))]
        norms += [(f"norms.{i}.scale", (c_out,)), (f"norms.{i}.bias", (c_out,))]
        for _ in range(group["num_blocks"]):
            c, cd, j = group["channels"], c_out, len(blocks)
            blocks.append([
                (f"blocks.{j}.conv.weight", (c, c, kh, kw)), (f"blocks.{j}.conv.bias", (c,)),
                (f"blocks.{j}.norm1.scale", (cd,)), (f"blocks.{j}.norm1.bias", (cd,)),
                (f"blocks.{j}.fc1.weight", (cd, cd)), (f"blocks.{j}.fc1.bias", (cd,)),
                (f"blocks.{j}.fc2.weight", (cd, cd)), (f"blocks.{j}.fc2.bias", (cd,)),
                (f"blocks.{j}.norm2.scale", (cd,)), (f"blocks.{j}.norm2.bias", (cd,)),
            ])
        c_in, h = c_out, h // group["stride"][0]
    head = [("linear.weight", (output_size, c_in * h)), ("linear.bias", (output_size,))]
    return convs + norms + [s for b in blocks for s in b] + head


def make_weights(shapes, seed, device):
    """A flat float32 vector of every parameter, drawn on ``device`` from
    ``seed`` in one call: weights normal with variance 1 / fan_in, biases
    0, norm scales 1.  Returns (flat, {name: view})."""
    counts = [math.prod(s) for _, s in shapes]
    std = [0.0 if n.endswith((".bias", ".scale")) else 1.0 / math.sqrt(math.prod(s[1:]))
           for n, s in shapes]
    offset = [1.0 if n.endswith(".scale") else 0.0 for n, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(counts)
    reps = torch.tensor(counts, device=device)
    flat = torch.randn(total, generator=gen, device=device)
    flat = flat * torch.repeat_interleave(torch.tensor(std, device=device), reps, output_size=total)
    flat = flat + torch.repeat_interleave(torch.tensor(offset, device=device), reps,
                                          output_size=total)
    return flat, views(flat, shapes)


def views(flat, shapes):
    out, pos = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def _out(n, stride):
    """Output length of a 'same'-padded odd kernel at ``stride``."""
    return -(-n // stride)


def forward_flops(model_cfg, input_size, output_size, width):
    """Multiply-adds x 2 of TDS2d's convolutions, dense layers and head on
    one line ``width`` pixels wide (its real, unpadded width)."""
    kh, kw = model_cfg["kernel_size"]
    depth = model_cfg["depth"]
    h, w, c_in, flops = input_size, width, 1, 0
    for group in model_cfg["tds_groups"]:
        sh, sw = group["stride"]
        c_out = depth * group["channels"]
        h, w = h // sh, _out(w, sw)
        flops += 2 * c_in * c_out * kh * kw * h * w
        c, cd = group["channels"], depth * group["channels"]
        per_block = 2 * c * c * kh * kw * depth * h * w + 2 * 2 * cd * cd * h * w
        flops += group["num_blocks"] * per_block
        c_in = c_out
    return flops + 2 * c_in * h * output_size * w


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def batch_inputs(images, device):
    """Float inputs [B, H, W] of uint8 line images: x / 255, normalised by
    IAM's pixel statistics, zero-padded on the right to a multiple of 16."""
    h = images[0].shape[0]
    width = -(-max(im.shape[1] for im in images) // WIDTH_MULTIPLE) * WIDTH_MULTIPLE
    x = np.zeros((len(images), h, width), np.float32)
    for b, im in enumerate(images):
        x[b, :, : im.shape[1]] = (im.astype(np.float32) / 255.0 - PIXEL_MEAN) / PIXEL_STD
    return torch.from_numpy(x).to(device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _dropout(x, p, gen):
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _norm(x, scale, bias):
    mean = x.mean(dim=(2, 3), keepdim=True)
    m2 = (x * x).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    y = (x - mean) * torch.rsqrt(var + NORM_EPS)
    return y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def _dense(x, weight, bias):
    """A dense layer over the channels of [B, C, H, W]."""
    return torch.einsum("bchw,oc->bohw", x, weight) + bias.view(1, -1, 1, 1)


def encoder(w, model_cfg, x, gen=None):
    """TDS2d logits [B, W', N] of inputs [B, H, W]; dropout where ``gen``
    is given (training)."""
    kh, kw = model_cfg["kernel_size"]
    depth, p = model_cfg["depth"], model_cfg["dropout"]
    pad = (kh // 2, kw // 2)
    B, H, W = x.shape
    x = x.view(B, 1, H, W)
    j = 0
    for i, group in enumerate(model_cfg["tds_groups"]):
        x = F.relu(F.conv2d(x, w[f"convs.{i}.weight"], w[f"convs.{i}.bias"],
                            tuple(group["stride"]), pad))
        x = _norm(_dropout(x, p, gen), w[f"norms.{i}.scale"], w[f"norms.{i}.bias"])
        C = group["channels"]
        for _ in range(group["num_blocks"]):
            pre = f"blocks.{j}."
            B_, CD, Hh, Ww = x.shape
            y = x.view(B_, C, depth, Hh, Ww).transpose(1, 2).reshape(B_ * depth, C, Hh, Ww)
            y = F.relu(F.conv2d(y, w[pre + "conv.weight"], w[pre + "conv.bias"], 1, pad))
            y = _dropout(y, p, gen)
            y = y.view(B_, depth, C, Hh, Ww).transpose(1, 2).reshape(B_, CD, Hh, Ww)
            x = _norm(y + x, w[pre + "norm1.scale"], w[pre + "norm1.bias"])
            y = _dropout(F.relu(_dense(x, w[pre + "fc1.weight"], w[pre + "fc1.bias"])), p, gen)
            y = _dropout(_dense(y, w[pre + "fc2.weight"], w[pre + "fc2.bias"]), p, gen)
            x = _norm(y + x, w[pre + "norm2.scale"], w[pre + "norm2.bias"])
            j += 1
    B_, C2, H2, W2 = x.shape
    x = x.permute(0, 3, 1, 2).reshape(B_, W2, C2 * H2)
    return x @ w["linear.weight"].t() + w["linear.bias"]


# ---------------------------------------------------------------------------
# Lattice
# ---------------------------------------------------------------------------


class Pieces:
    """An inventory of pieces, each a tuple of unit ids, with its label."""

    def __init__(self, pieces):
        self.label = {}
        for i, piece in enumerate(pieces):
            self.label.setdefault(tuple(piece), i)
        self.max_len = max(len(p) for p in self.label)

    @classmethod
    def units(cls, n):
        """One piece a unit: the CTC case."""
        return cls([(i,) for i in range(n)])

    def occurrences(self, target):
        """[(start, end, label)] of every piece that spells target[start:end]."""
        target = tuple(int(t) for t in target)
        out = []
        for a in range(len(target)):
            for b in range(a + 1, min(len(target), a + self.max_len) + 1):
                lab = self.label.get(target[a:b])
                if lab is not None:
                    out.append((a, b, lab))
        return out


def lattice(target, pieces, blank):
    """(labels [S], preds [S, K], start [S], accept [S]) of one target:
    states 0..L are the blanks after 0..L units, then one state an
    occurrence; preds lists each state's predecessors, itself included,
    padded with -1."""
    L = len(target)
    occ = pieces.occurrences(target)
    labels = [blank] * (L + 1) + [lab for _, _, lab in occ]
    preds = [[i] for i in range(L + 1)]
    start = [i == 0 for i in range(L + 1)]
    accept = [i == L for i in range(L + 1)]
    ending = {}
    for k, (a, b, lab) in enumerate(occ):
        ending.setdefault(b, []).append((L + 1 + k, lab))
    for k, (a, b, lab) in enumerate(occ):
        s = L + 1 + k
        preds[b].append(s)
        preds.append([s, a] + [q for q, ql in ending.get(a, ()) if ql != lab])
        start.append(a == 0)
        accept.append(b == L)
    K = max(len(p) for p in preds)
    P = np.full((len(preds), K), -1, np.int64)
    for s, p in enumerate(preds):
        P[s, : len(p)] = p
    return (np.asarray(labels, np.int64), P, np.asarray(start), np.asarray(accept))


def _stack(lattices, device):
    S = max(len(l[0]) for l in lattices)
    K = max(l[1].shape[1] for l in lattices)
    B = len(lattices)
    labels = np.zeros((B, S), np.int64)
    preds = np.full((B, S, K), S, np.int64)  # S: a dead state
    start = np.zeros((B, S), bool)
    accept = np.zeros((B, S), bool)
    for b, (lab, P, st, ac) in enumerate(lattices):
        n, k = P.shape
        labels[b, :n] = lab
        preds[b, :n, :k] = np.where(P >= 0, P, S)
        start[b, :n] = st
        accept[b, :n] = ac
    t = lambda a: torch.from_numpy(a).to(device)
    return t(labels), t(preds), t(start), t(accept)


def _scan(lp, lattices, reduce):
    """The lattices' scores [B] over log-probs lp [B, T, N]: reduce is
    ``_lse`` (the total weight) or ``_max`` (the best path).  Unreachable
    states hold NEG, a finite floor, so that no gradient is 0 * inf."""
    B, T, _ = lp.shape
    labels, preds, start, accept = _stack(lattices, lp.device)
    S = labels.shape[1]
    em = torch.gather(lp, 2, labels.unsqueeze(1).expand(B, T, S))  # [B, T, S]
    dead = torch.full((B, 1), NEG, device=lp.device, dtype=lp.dtype)
    alpha = torch.where(start, em[:, 0], NEG)
    flat_preds = preds.view(B, -1)
    for t in range(1, T):
        prev = torch.gather(torch.cat([alpha, dead], dim=1), 1, flat_preds)
        alpha = reduce(prev.view(preds.shape)) + em[:, t]
    return reduce(torch.where(accept, alpha, NEG))


def _lse(x):
    return torch.logsumexp(x, dim=-1)


def _max(x):
    return torch.amax(x, dim=-1)


def loss(logits, targets, pieces, blank):
    """The batch-mean loss of each target's lattice divided by its length."""
    lp = torch.log_softmax(logits, dim=2)
    lats = [lattice(t, pieces, blank) for t in targets]
    score = _scan(lp, lats, _lse)
    lens = torch.tensor([max(len(t), 1) for t in targets], dtype=lp.dtype, device=lp.device)
    return torch.mean(-score / lens)


def decode_gap(logits, predictions, blank):
    """[B] gaps in nats between the best frame labelling under ``logits``
    and the best one that collapses to each prediction: 0 for the greedy
    decode, infinite where none does."""
    lp = torch.log_softmax(logits.detach(), dim=2)
    n = lp.shape[2]
    lats = [lattice(p, Pieces.units(n), blank) for p in predictions]
    best = lp.amax(dim=2).sum(dim=1)
    return (best - _scan(lp, lats, _max)).clamp(min=0.0)


def lattice_size(target, pieces, blank):
    """(states, arcs) of one target's lattice: arcs count each predecessor."""
    labels, P, _, _ = lattice(target, pieces, blank)
    return len(labels), int((P >= 0).sum())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_step(w, model_cfg, optim_cfg, x, targets, pieces, blank, gen):
    """One SGD step on the parameter dict ``w`` (updated in place): the
    loss, dropout from ``gen``, the gradient clipped by its global norm to
    ``max_grad_norm``, p -= lr * g.  Returns (loss, logits, clipped
    gradients by name)."""
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    logits = encoder(params, model_cfg, x, gen)
    value = loss(logits, targets, pieces, blank)
    grads = torch.autograd.grad(value, list(params.values()))
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    max_norm = optim_cfg.get("max_grad_norm")
    scale = 1.0 if max_norm is None else torch.clamp(
        max_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
    lr = optim_cfg["learning_rate"]
    clipped = {}
    with torch.no_grad():
        for (k, v), g in zip(w.items(), grads):
            clipped[k] = g * scale
            v.sub_(lr * clipped[k])
    return value.detach(), logits.detach(), clipped


# ---------------------------------------------------------------------------
# The recipe's task
# ---------------------------------------------------------------------------


WORDSEP = "▁"


class Task:
    """What a recipe scores, worked out from its configuration and the
    corpus's characters: the pieces over grapheme ids, the blank (the last
    channel), the model's output size and each line's target."""

    def __init__(self, cfg, chars, root):
        self.model_cfg = cfg["model"]
        self.optim_cfg = cfg["optim"]
        self.input_size = cfg["data"]["num_features"]
        self.index = {c: i for i, c in enumerate(chars)}
        self.prepend = cfg["data"].get("prepend_wordsep", False)
        kind = cfg.get("criterion_type", "ctc")
        if kind == "ctc":
            self.pieces = Pieces.units(len(chars))
            self.blank = len(chars)
        elif kind == "transducer":
            crit = cfg.get("criterion", {})
            if (crit.get("blank") != "optional" or crit.get("allow_repeats", True)
                    or crit.get("ngram", 0) or crit.get("transitions")):
                raise ValueError("the reference scores blank 'optional' without repeats "
                                 "or transitions")
            with open(f"{root}/{cfg['tokens_file']}", encoding="utf8") as fid:
                tokens = [line.strip() for line in fid]
            self.pieces = Pieces([tuple(self.index[c] for c in t) for t in tokens])
            self.blank = len(tokens)
        else:
            raise ValueError(f"no reference for criterion {kind!r}")
        self.output_size = self.blank + 1
        self.shapes = param_shapes(self.model_cfg, self.input_size, self.output_size)

    def make_weights(self, seed, device):
        return make_weights(self.shapes, seed, device)[0]

    def views(self, flat):
        return views(flat, self.shapes)

    def lattice_size(self, text):
        return lattice_size(self.target(text), self.pieces, self.blank)

    def forward_flops(self, width):
        """The model's forward FLOPs on one input ``width`` frames wide."""
        return forward_flops(self.model_cfg, self.input_size, self.output_size, width)

    def target(self, text):
        text = WORDSEP + text if self.prepend else text
        return [self.index[c] for c in text]

    def time_stride(self):
        return math.prod(g["stride"][1] for g in self.model_cfg["tds_groups"])


def greedy(logits, blank):
    """Best-path decodes of logits [B, T, N]: runs merged, blanks dropped."""
    labels = logits.argmax(dim=2).cpu().numpy()
    out = []
    for row in labels:
        keep = np.ones(len(row), bool)
        keep[1:] = row[1:] != row[:-1]
        out.append(row[keep & (row != blank)])
    return out
