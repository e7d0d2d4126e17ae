"""Pruned n-gram transition WFST builder.

A copy of ``gtn_applications_tpu/scripts/build_transitions.py``, kept in
the port so that building a transition graph imports nothing of the JAX
package; both write the same graph file, arc for arc.

    python -m gtn_applications_tpu_torch.scripts.build_transitions \
        --data_path train.txt --tokens tokens.txt --prune 0 5 10 \
        --blank optional --save_path transitions.bin

Behavioral spec: the reference's ``scripts/build_transitions.py`` — count
n-grams over tokenized training text with <s>/</s> sentinels, prune by
per-order count thresholds, optionally enumerate blank insertions
(optional / forced) and token self-loops, and assemble a Katz-style
backoff WFST with epsilon back-off arcs.  The output graph is saved in the
framework's binary format and is consumed by the Transducer criterion as a
learnable-weight transition model (utils.load_criterion).

The construction here is re-derived from that spec: counting is windowed
over the sentinel-wrapped id sequence, the blank/self-loop enumerations
work on explicit gap masks and run duplication, and the graph assembly
routes through a ContextIndex that owns state creation and backoff wiring.
"""

import argparse
import collections
import itertools

from ..wfst.graph import EPSILON, Graph

START_IDX = -1
END_IDX = -2
WORDSEP = "▁"


class _ContextIndex:
    """Maps context tuples to graph node ids, creating nodes on demand.

    When a node is created, a single epsilon back-off arc is added to the
    longest proper-suffix context that exists *at creation time* (so the
    result depends on traversal order exactly as in the reference CLI,
    which processes grams in ascending order).  End-of-sentence contexts
    never back off.
    """

    def __init__(self, graph, order, backoff=True):
        self._graph = graph
        self._order = order
        self._backoff = backoff
        self._nodes = {}

    def __contains__(self, ctx):
        return ctx in self._nodes

    def node(self, ctx):
        found = self._nodes.get(ctx)
        if found is not None:
            return found
        if self._order == 1:
            is_start = is_end = True
        else:
            is_start = ctx == (START_IDX,)
            is_end = ctx == (END_IDX,)
        nid = self._graph.add_node(is_start, is_end)
        self._nodes[ctx] = nid
        if self._backoff and not is_end:
            for cut in range(1, len(ctx) + 1):
                shorter = self._nodes.get(ctx[cut:])
                if shorter is not None:
                    self._graph.add_arc(nid, shorter, EPSILON)
                    break
        return nid


def build_graph(ngrams, disable_backoff=False) -> Graph:
    """Assemble the backoff WFST from kept n-grams.

    States are token histories; each kept gram adds an arc from its history
    state to its successor state (labelled with the gram's final token, or
    epsilon for </s>); all </s>-containing successor states merge into one.
    """
    order = len(ngrams)
    graph = Graph()
    contexts = _ContextIndex(graph, order, backoff=not disable_backoff)
    for grams in ngrams:
        for gram in grams:
            src = contexts.node(gram[:-1])
            if END_IDX not in gram[1:] and gram[1:] not in contexts:
                raise ValueError(
                    "inconsistent pruned counts: a kept gram's suffix "
                    f"{gram[1:]} must itself be kept one order down"
                )
            # successor history: the last (order-1) tokens of the gram
            succ = gram[1 - order :] if order > 1 else ()
            if END_IDX in succ:
                succ = (END_IDX,)
            dst = contexts.node(succ)
            label = EPSILON if gram[-1] == END_IDX else gram[-1]
            graph.add_arc(src, dst, label)
    return graph


def count_ngrams(lines, ngram, tokens_to_idx):
    """Per-order n-gram counters with <s>/</s> sentinels.

    Unigram counts never include <s>; they include </s> only when the model
    order is above 1 (for a pure unigram model the end sentinel would be
    the only epsilon arc and is dropped, matching the reference offsets).
    """
    counts = [collections.Counter() for _ in range(ngram)]
    end_in_unigrams = ngram > 1
    for line in lines:
        seq = [START_IDX, *(tokens_to_idx[t] for t in line), END_IDX]
        for width, counter in enumerate(counts, start=1):
            for window in zip(*(seq[i:] for i in range(width))):
                if width == 1:
                    if window[0] == START_IDX:
                        continue
                    if window[0] == END_IDX and not end_in_unigrams:
                        continue
                counter[window] += 1
    return counts


def prune_ngrams(ngrams, prune):
    """Keep grams whose count strictly exceeds the per-order threshold,
    ordered most-frequent first."""
    return [
        [gram for gram, count in counter.most_common() if count > threshold]
        for counter, threshold in zip(ngrams, prune)
    ]


def _with_blanks(gram, gap_mask, blank_id):
    """Expand `gram` by inserting blank_id at the gaps selected by
    `gap_mask` (len(gram)+1 slots: before each token, plus after the last).
    Insertions adjacent to the sentinels are suppressed."""
    expanded = []
    for slot, tok in enumerate(gram):
        if gap_mask[slot] and tok != START_IDX:
            expanded.append(blank_id)
        expanded.append(tok)
    if gap_mask[-1] and gram[-1] != END_IDX:
        expanded.append(blank_id)
    return expanded


def add_blank_grams(pruned_ngrams, num_tokens, blank):
    """Grow the kept-gram lists with blank-token insertions.

    'optional' enumerates every subset of insertion gaps per kept gram;
    'forced' fills every gap and additionally drops all kept grams above
    order 1 (direct token-token transitions become illegal).  Every new
    sub-window of an expanded sequence that contains the blank is added at
    its own order.  The blank id is num_tokens.
    """
    if blank not in ("optional", "forced"):
        raise ValueError(
            f"blank={blank!r}: expected 'optional' or 'forced' "
            "(use 'none' by not calling this at all)"
        )
    blank_id = num_tokens
    source_grams = [g for grams in pruned_ngrams for g in grams]
    max_order = len(pruned_ngrams)
    if blank == "forced":
        pruned_ngrams = [pruned_ngrams[0]] + [[] for _ in range(max_order - 1)]
    seen = {(blank_id,)}
    pruned_ngrams[0].append((blank_id,))
    for gram in source_grams:
        gaps = len(gram) + 1
        if blank == "forced":
            masks = [(1,) * gaps]
        else:
            masks = itertools.product((0, 1), repeat=gaps)
        for mask in masks:
            expanded = _with_blanks(gram, mask, blank_id)
            for width in range(1, max_order + 1):
                for lo in range(len(expanded) - width + 1):
                    window = tuple(expanded[lo : lo + width])
                    if blank_id in window and window not in seen:
                        seen.add(window)
                        pruned_ngrams[width - 1].append(window)
    return pruned_ngrams


def add_self_loops(pruned_ngrams):
    """For every kept gram one order down, duplicate each non-sentinel
    token in place (a token-repeat gram) and keep it if new."""
    known = set(itertools.chain.from_iterable(pruned_ngrams))
    for order in range(2, len(pruned_ngrams) + 1):
        for gram in pruned_ngrams[order - 2]:
            for pos, tok in enumerate(gram):
                if tok in (START_IDX, END_IDX):
                    continue
                doubled = gram[:pos] + (tok,) + gram[pos:]
                if doubled not in known:
                    known.add(doubled)
                    pruned_ngrams[order - 1].append(doubled)
    return pruned_ngrams


def parse_lines(lines, lexicon):
    """Tokenize word-separated lines through a word -> pieces lexicon."""
    table = {}
    with open(lexicon, "r") as fid:
        for row in fid:
            word, *pieces = row.split()
            table[word] = pieces
    out = []
    for line in lines:
        toks = []
        for word in line.split(WORDSEP):
            toks.extend(table[word])
        out.append(toks)
    return out


def _read_lines(path):
    with open(path, "r") as fid:
        return [ln.strip() for ln in fid]


def build_from_lines(lines, tokens, prune, blank="none", self_loops=False,
                     disable_backoff=False, verbose=False):
    """The transition graph of tokenized ``lines`` over ``tokens``: the
    steps of ``main`` without the files.  ``prune`` gives the per-order
    count thresholds (its length is the model order)."""
    if any(a > b for a, b in zip(prune, prune[1:])):
        raise ValueError("Pruning values must be non-decreasing.")
    order = len(prune)
    tokens_to_idx = {t: i for i, t in enumerate(tokens)}
    ngrams = count_ngrams(lines, order, tokens_to_idx)
    kept = prune_ngrams(ngrams, prune)
    if verbose:
        for n in range(order):
            print(f"Kept {len(kept[n])} of {len(ngrams[n])} {n + 1}-grams")
    if blank != "none":
        kept = add_blank_grams(kept, len(tokens_to_idx), blank)
    if self_loops:
        kept = add_self_loops(kept)
    return build_graph(kept, disable_backoff)


def grapheme_lm(texts, tokens, prune=(0, 5, 10), blank="optional"):
    """The transition graph of the IAM recipe's settings
    (``scripts/iamdb_transitions.sh``: ``--prune 0 5 10 --blank
    optional``, a trigram) over the graphemes of ``texts``."""
    return build_from_lines([list(t) for t in texts], tokens, list(prune), blank)


def main(argv=None):
    from ..wfst import graph as wgraph

    parser = argparse.ArgumentParser(description="Build transition graphs.")
    parser.add_argument("--data_path", type=str, help="Path to train text.")
    parser.add_argument("--tokens", type=str, help="Path to token list.")
    parser.add_argument("--lexicon", type=str, default=None)
    parser.add_argument("--prune", metavar="N", type=int, nargs="+")
    parser.add_argument(
        "--blank", default="none", choices=["none", "optional", "forced"]
    )
    parser.add_argument("--add_self_loops", action="store_true")
    parser.add_argument("--disable_backoff", action="store_true")
    parser.add_argument("--save_path", default=None)
    args = parser.parse_args(argv)

    print(f"Building {len(args.prune)}-gram transition model")
    lines = _read_lines(args.data_path)
    tokens = _read_lines(args.tokens)
    if args.lexicon is not None:
        lines = parse_lines(lines, args.lexicon)
    print("Counting data and building the graph from pruned ngrams...")
    graph = build_from_lines(lines, tokens, args.prune, args.blank,
                             args.add_self_loops, args.disable_backoff,
                             verbose=True)
    print(f"Graph has {graph.num_arcs()} arcs and {graph.num_nodes()} nodes.")
    print(f"Saving graph to {args.save_path}")
    wgraph.save(args.save_path, graph)


if __name__ == "__main__":
    main()
