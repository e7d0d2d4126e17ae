import numpy as np

from perfbench import bench, traffic


def _spec():
    return bench.Cell("iam_tds2d_ctc.train").traffic


def test_same_seed_same_corpus():
    a = traffic.make_corpus(_spec(), 2**31 + 11, bench.ROOT)
    b = traffic.make_corpus(_spec(), 2**31 + 11, bench.ROOT)
    assert a.texts == b.texts
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images))


def test_seeds_share_the_work():
    """Every seed renders the same lines at the same sizes; only the
    pixels change."""
    a = traffic.make_corpus(_spec(), 1, bench.ROOT)
    b = traffic.make_corpus(_spec(), 2, bench.ROOT)
    assert a.texts == b.texts
    assert [im.shape for im in a.images] == [im.shape for im in b.images]
    assert not all(np.array_equal(x, y) for x, y in zip(a.images, b.images))


def test_iam_geometry():
    spec = _spec()
    c = traffic.make_corpus(spec, 3, bench.ROOT)
    lengths = np.asarray([len(t) for t in c.texts])
    widths = np.asarray([im.shape[1] for im in c.images])
    assert len(c.texts) == spec["lines"] == 1024
    assert lengths.min() >= 8 and lengths.max() <= 90
    assert abs(lengths.mean() - 44) < 1.5 and abs(lengths.std() - 12) < 1.5
    assert all(im.shape[0] == 64 and im.dtype == np.uint8 for im in c.images)
    assert abs(widths.mean() - 1012) < 60
    assert widths.min() >= 8 * 18 and widths.max() <= 90 * 28
    # a glyph is round(23 x hand) pixels wide, hand in [0.8, 1.2]
    glyph = widths / lengths
    assert glyph.min() >= 18 and glyph.max() <= 28


def test_text_is_words_of_the_inventory():
    c = traffic.make_corpus(_spec(), 4, bench.ROOT)
    gen = traffic.generator(_spec(), bench.ROOT)
    pieces, _ = gen.read_inventory(bench.ROOT / _spec()["text"]["inventory"])
    words = {p[1:] for p in pieces if p.startswith(gen.WORDSEP)}
    inner = [w for t in c.texts[:50] for w in t.split(gen.WORDSEP)[1:-1]]
    assert inner and sum(w in words for w in inner) / len(inner) > 0.95
    assert set("".join(c.texts)) <= set(c.chars) and len(c.chars) == 78


def test_traffic_names_its_generator():
    """Each traffic file names a generator module that makes the corpus
    and the port's dataset over it."""
    for w in bench.Cell("iam_tds2d_ctc.train").spec["workloads"]:
        spec = bench.Cell(w["name"]).traffic
        gen = traffic.generator(spec, bench.ROOT)
        assert callable(gen.make_corpus) and callable(gen.make_dataset)
