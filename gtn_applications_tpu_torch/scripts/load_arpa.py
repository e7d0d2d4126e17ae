"""ARPA language model -> backoff WFST loader.

A copy of ``gtn_applications_tpu/scripts/load_arpa.py``: parse ARPA n-gram
log10 probabilities and backoff weights, assemble the backoff LM WFST
(epsilon backoff arcs carrying the backoff weights), and build sentence
chain graphs for scoring.  ``score_sentence`` implements the standard
backoff recursion directly as an independent oracle (kenlm's ``score``),
and ``main`` checks the WFST against it through ``wfst.ops.intersect`` and
``viterbi_score``:

    python -m gtn_applications_tpu_torch.scripts.load_arpa --arpa LM.arpa

The parser reads the file as a stripped-line list and walks it section by
section (``\\data\\`` / ``\\N-grams:`` / ``\\end\\``).
"""

from ..wfst.graph import EPSILON, Graph

UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"


def read_counts_from_arpa(arpa_file):
    """Parse an ARPA file.

    Returns ``(tables, vocab)`` where ``tables[n-1]`` maps each order-n
    gram (a tuple of vocab ids) to ``(log10_prob, backoff)``; the backoff
    is 0.0 when the entry omits it at a non-top order and None at the top
    order.  ``vocab`` maps word string to id in unigram-section order.
    """
    with open(arpa_file, "r") as fid:
        lines = [ln.strip() for ln in fid]

    # header: "ngram N=count" declarations between \data\ and a blank line
    at = lines.index("\\data\\") + 1
    declared = []
    while at < len(lines) and lines[at]:
        field, _, size = lines[at].partition("=")
        parts = field.split()
        if parts[0] != "ngram" or int(parts[1]) != len(declared) + 1:
            raise ValueError(f"malformed ARPA header line: {lines[at]!r}")
        declared.append(int(size))
        at += 1
    order = len(declared)

    vocab = {}
    tables = [{} for _ in range(order)]
    for n in range(1, order + 1):
        at = lines.index(f"\\{n}-grams:", at) + 1
        table = tables[n - 1]
        while at < len(lines) and lines[at] and lines[at] != "\\end\\":
            fields = lines[at].split()
            at += 1
            logp = float(fields[0])
            words = fields[1 : n + 1]
            if n == 1:
                vocab.setdefault(words[0], len(vocab))
            gram = tuple(vocab[w] for w in words)
            if len(fields) > n + 1:
                backoff = float(fields[n + 1])
            else:
                backoff = 0.0 if n < order else None
            table[gram] = (logp, backoff)
    if len(vocab) != declared[0]:
        raise ValueError(
            f"unigram section has {len(vocab)} entries, header declared "
            f"{declared[0]}"
        )
    return tables, vocab


def build_lm_graph(ngram_counts, vocab) -> Graph:
    """Backoff LM WFST: a state per history, word arcs weighted with log10
    probabilities, and an epsilon arc from each gram's successor state to
    its one-shorter history carrying the backoff weight."""
    order = len(ngram_counts)
    if order < 2:
        raise ValueError("backoff LM graph requires order >= 2")
    bos, eos = vocab[BOS], vocab[EOS]
    graph = Graph()
    nodes = {}

    def history_node(ctx):
        if ctx not in nodes:
            nodes[ctx] = graph.add_node(ctx == (bos,), eos in ctx)
        return nodes[ctx]

    for table in ngram_counts:
        for gram, (logp, backoff) in table.items():
            src = history_node(gram[:-1])
            dst = history_node(gram[1 - order :])
            label = EPSILON if gram[-1] == eos else gram[-1]
            graph.add_arc(src, dst, label, label, logp)
            if backoff is not None and eos not in gram:
                graph.add_arc(
                    dst, history_node(gram[1:]), EPSILON, EPSILON, backoff
                )
    return graph


def build_sentence_graph(sentence, vocab) -> Graph:
    """Word chain acceptor with <unk> fallback."""
    unk = vocab[UNK]
    ids = [vocab.get(w, unk) for w in sentence.split()]
    graph = Graph()
    chain = [graph.add_node(i == 0, i == len(ids) and i > 0) for i in range(len(ids) + 1)]
    for i, idx in enumerate(ids):
        graph.add_arc(chain[i], chain[i + 1], idx)
    return graph


# the reference's spelling
build_setence_graph = build_sentence_graph


def score_sentence(counts, vocab, sentence, bos=True, eos=True):
    """Direct backoff-recursion scorer (kenlm .score oracle replacement):
    log10 P(sentence </s> | <s>) with standard Katz backoff."""
    lm_order = len(counts)
    words = [vocab.get(w, vocab[UNK]) for w in sentence.split()]
    seq = ([vocab[BOS]] if bos else []) + words + ([vocab[EOS]] if eos else [])
    total = 0.0
    start = 1 if bos else 0
    for i in range(start, len(seq)):
        hist = tuple(seq[max(0, i - lm_order + 1) : i])
        word = seq[i]
        total += _backoff_score(counts, hist, word)
    return total


def _backoff_score(counts, hist, word):
    order = len(hist) + 1
    gram = hist + (word,)
    entry = counts[order - 1].get(gram)
    if entry is not None:
        return entry[0]
    if not hist:
        # true OOV relative to the unigram table
        return float("-inf")
    # backoff weight of the history (0 if unlisted)
    h_entry = counts[len(hist) - 1].get(hist)
    bow = h_entry[1] if h_entry is not None and h_entry[1] is not None else 0.0
    return bow + _backoff_score(counts, hist[1:], word)


def main(argv=None):
    import argparse
    import random

    from ..wfst import ops as wops

    parser = argparse.ArgumentParser(
        description="Load an ARPA LM as a WFST and self-test scoring parity."
    )
    parser.add_argument("--arpa", type=str, required=True)
    parser.add_argument("--sentences", type=int, default=25)
    parser.add_argument("--write_dot", type=str, default=None)
    args = parser.parse_args(argv)

    counts, vocab = read_counts_from_arpa(args.arpa)
    g_lm = build_lm_graph(counts, vocab)
    print(f"LM graph: {g_lm.num_nodes()} nodes, {g_lm.num_arcs()} arcs")
    if args.write_dot:
        from ..wfst import graph as wgraph

        symb = {v: k for k, v in vocab.items()}
        wgraph.write_dot(g_lm, args.write_dot, symb, symb)

    rng = random.Random(0)
    words = list(vocab.keys())
    for _ in range(args.sentences):
        length = rng.randint(1, 20)
        sentence = " ".join(rng.choice(words) for _ in range(length))
        g_sent = build_sentence_graph(sentence, vocab)
        g_score = wops.intersect(g_lm, g_sent)
        wfst_score = wops.viterbi_score(g_score)
        oracle = score_sentence(counts, vocab, sentence)
        print(f'"{sentence}"; wfst:{wfst_score}; oracle:{oracle}')
        assert abs(wfst_score - oracle) < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
