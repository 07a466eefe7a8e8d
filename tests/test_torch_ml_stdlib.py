"""The port's ``pw.ml`` stdlib against the JAX package's, on the CPU.

The fuzzy joins, the HMM reducer, the dataset loader and the KNN
classifier (``knn_lsh_classifier_train`` / ``knn_lsh_classify``, on each
package's ``KNNIndex``) with ``classifier_accuracy``. Every case builds
the same pipeline with ``pathway_tpu`` and with ``pathway_tpu_torch``
(``build(pw)``) at 1 and 4 engine workers. The fuzzy joins, the HMM and
the loader are host code in both packages: final tables and update
streams are held exactly, and to the values the reference's
``tests/test_ml_stdlib.py`` states. The classifier scores in f32 in both
(JAX on the CPU, the port's plain top-k), so its labels are held exactly
on every query whose neighbours f32 cannot reorder: the 3rd and 4th
squared distances of a float64 numpy search apart by more than 1e-5
relative, and, where the three labels differ, the 1st and 2nd too (ROADMAP
Queue C's near-ties); there the labels also equal a plain majority vote
(``collections.Counter.most_common`` in rank order). The reference has no
test of the classifier; its cases are a seeded numpy table and
``load_mnist_sample(synthetic=True)`` at d 784."""

from __future__ import annotations

import collections
from functools import partial

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.graph_runner import GraphRunner as JRunner
from pathway_tpu_torch.internals.graph_runner import GraphRunner as TRunner

RUNNERS = {jpw: JRunner, tpw: TRunner}
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True)
def _clear_graphs():
    jpw.clear_graph()
    tpw.clear_graph()
    yield
    jpw.clear_graph()
    tpw.clear_graph()


def _norm(v):
    """A value comparable across the packages: each has its own ``Pointer``."""
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, tuple(v.ravel().tolist()))
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    return v


def _run_tables(pw, tables, n_workers):
    """[(final state {key: row}, update stream, column names)] of ``tables``, one run."""
    runner = RUNNERS[pw](n_workers=n_workers)
    caps = [runner.capture(t) for t in tables]
    runner.run()
    pw.clear_graph()
    out = []
    for cap, names in caps:
        stream = sorted(((int(k), _norm(tuple(r)), int(t), int(d)) for k, r, t, d in cap.stream),
                        key=lambda e: (e[2], e[0], e[3], repr(e[1])))
        out.append(({int(k): _norm(tuple(r)) for k, r in cap.state.items()}, stream, list(names)))
    return out


def _run(pw, build, n_workers):
    return _run_tables(pw, [build(pw)], n_workers)[0]


# ---- fuzzy joins (reference tests/test_ml_stdlib.py) ----


def _names(pw, rows):
    return pw.debug.table_from_markdown("      | name\n" + "".join(f"    {k} | {n}\n" for k, n in rows))


LEFT = [(1, "john smith"), (2, "alice cooper"), (3, "bob marley")]
RIGHT = [(11, "smith john"), (12, "cooper alice"), (13, "marley bob")]


def _fuzzy_match_tables(pw):
    return pw.ml.fuzzy_match_tables(_names(pw, LEFT), _names(pw, RIGHT))


def _smart_fuzzy_match(pw):
    left, right = _names(pw, [(1, "aa bb cc"), (2, "aa bb")]), _names(pw, [(11, "aa bb cc"), (12, "aa")])
    return pw.ml.smart_fuzzy_match(left.name, right.name)


def _fuzzy_self_match(pw):
    t = _names(pw, [(1, "data stream processing"), (2, "stream data processing"), (3, "quantum chess")])
    return pw.ml.smart_fuzzy_match(t.name, t.name)


def _smart_fuzzy_match_by_hand(pw):
    left = _names(pw, LEFT).with_id_from(pw.this.name)
    right = _names(pw, RIGHT).with_id_from(pw.this.name)
    hint = pw.debug.table_from_markdown("""
      | l          | r
    1 | john smith | marley bob
    """)
    hint = hint.select(left=left.pointer_from(hint.l), right=right.pointer_from(hint.r), weight=1.0)
    return pw.ml.smart_fuzzy_match(left.name, right.name, by_hand_match=hint)


CASES = {
    "fuzzy_match_tables": _fuzzy_match_tables,
    "smart_fuzzy_match": _smart_fuzzy_match,
    "fuzzy_self_match": _fuzzy_self_match,
    "smart_fuzzy_match_by_hand": _smart_fuzzy_match_by_hand,
}


def _pairs(state):
    """{(left, right)} of a match table (pointers or the edges' own node ids)."""
    node = lambda v: v[1] if isinstance(v, tuple) else v  # noqa: E731
    return {(node(row[0]), node(row[1])) for row in state.values()}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fuzzy_match_case_equals_reference(case, n_workers):
    want = _run(jpw, CASES[case], n_workers)
    got = _run(tpw, CASES[case], n_workers)
    assert got == want
    assert got[1], "the pipeline produced no update"
    pairs = _pairs(got[0])
    if case == "fuzzy_match_tables":
        left = {r[0]: k for k, r in _run(tpw, lambda pw: _names(pw, LEFT), 1)[0].items()}
        right = {r[0]: k for k, r in _run(tpw, lambda pw: _names(pw, RIGHT), 1)[0].items()}
        assert pairs == {(left["john smith"], right["smith john"]), (left["alice cooper"], right["cooper alice"]),
                         (left["bob marley"], right["marley bob"])}
    elif case == "smart_fuzzy_match":
        left = {r[0]: k for k, r in _run(tpw, lambda pw: _names(pw, [(1, "aa bb cc"), (2, "aa bb")]), 1)[0].items()}
        right = {r[0]: k for k, r in _run(tpw, lambda pw: _names(pw, [(11, "aa bb cc"), (12, "aa")]), 1)[0].items()}
        assert {(left["aa bb cc"], right["aa bb cc"]), (left["aa bb"], right["aa"])} <= pairs
    elif case == "fuzzy_self_match":
        assert len(pairs) == 1


def test_fuzzy_match_low_level_api_equals_reference():
    """``fuzzy_match`` over hand-made edges and features (the reference's
    ``test_fuzzy_match_low_level_api``): two matches, equal in both; and
    ``fuzzy_self_match`` and ``fuzzy_match_with_hint`` over the same
    edges."""
    got = {}
    for pw in (jpw, tpw):
        feats = pw.debug.table_from_markdown("""
           | weight | normalization_type
        f1 | 1.0    | 3
        f2 | 1.0    | 3
        """)
        (state, _stream, _names_) = _run(pw, lambda pw: feats.select(w=pw.this.weight), 1)
        f1, f2 = (pw.Pointer(k) for k in sorted(state))

        class EdgeSchema(pw.Schema):
            node: int
            feature: pw.Pointer
            weight: float

        def build(pw, f1=f1, f2=f2, schema=EdgeSchema):
            feats = pw.debug.table_from_markdown("""
               | weight | normalization_type
            f1 | 1.0    | 3
            f2 | 1.0    | 3
            """)
            el = pw.debug.table_from_rows(schema, [(1, f1, 1.0), (2, f2, 1.0)])
            er = pw.debug.table_from_rows(schema, [(11, f1, 1.0), (12, f2, 1.0)])
            hint = pw.debug.table_from_markdown("""
              | l | r
            1 | 1 | 12
            """).select(left=pw.this.l, right=pw.this.r, weight=1.0)
            both = el.concat_reindex(er)
            return [pw.ml.fuzzy_match(el, er, feats), pw.ml.smart_table_ops.fuzzy_self_match(both, feats),
                    pw.ml.fuzzy_match_with_hint(el, er, feats, hint)]

        got[pw] = [_run_tables(pw, build(pw), n) for n in (1, 4)]
    assert got[tpw] == got[jpw]
    assert len(_pairs(got[tpw][0][0][0])) == 2 and got[tpw][0][2][0]


# ---- HMM (reference tests/test_ml_stdlib.py) ----


def _emission(observation, state, table):
    return float(np.log(table[(state, observation)]))


def _hmm_graph(start_nodes=None):
    import networkx as nx

    if start_nodes is None:
        table = {("HUNGRY", "GRUMPY"): 0.9, ("HUNGRY", "HAPPY"): 0.1, ("FULL", "GRUMPY"): 0.3, ("FULL", "HAPPY"): 0.7}
        g = nx.DiGraph()
        trans = {("HUNGRY", "HUNGRY"): 0.4, ("HUNGRY", "FULL"): 0.6, ("FULL", "HUNGRY"): 0.6, ("FULL", "FULL"): 0.4}
    else:
        table = {("HUNGRY", "HAPPY"): 0.1, ("FULL", "HAPPY"): 0.9, ("HUNGRY", "GRUMPY"): 0.9, ("FULL", "GRUMPY"): 0.1}
        g = nx.DiGraph(start_nodes=start_nodes)
        trans = {(a, b): 0.5 for a in ("HUNGRY", "FULL") for b in ("HUNGRY", "FULL")}
    for s in ("HUNGRY", "FULL"):
        g.add_node(s, calc_emission_log_ppb=partial(_emission, state=s, table=table))
    for (a, b), p in trans.items():
        g.add_edge(a, b, log_transition_ppb=float(np.log(p)))
    return g


def _hmm(observations, start_nodes=None, streamed=False):
    def build(pw):
        rows = "".join(f"    {i + 1} | {o} | {g}" + (f" | {2 * (i + 1)}" if streamed else "") + "\n"
                       for i, (o, g) in enumerate(observations))
        header = "      | observation | g" + (" | __time__" if streamed else "")
        obs = pw.debug.table_from_markdown(header + "\n" + rows)
        hmm = pw.ml.create_hmm_reducer(_hmm_graph(start_nodes))
        return obs.groupby(pw.this.g).reduce(g=pw.this.g, path=hmm(pw.this.observation))

    return build


HMM_CASES = {
    "hmm_reducer": _hmm([("GRUMPY", 0), ("GRUMPY", 0), ("HAPPY", 0)]),
    "hmm_start_nodes": _hmm([("HAPPY", 0)], start_nodes=["HUNGRY"]),
    "hmm_streamed_groups": _hmm([("GRUMPY", 0), ("HAPPY", 1), ("HAPPY", 0), ("GRUMPY", 1), ("HAPPY", 0)],
                                streamed=True),
}


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("case", sorted(HMM_CASES))
def test_hmm_case_equals_reference(case, n_workers):
    want = _run(jpw, HMM_CASES[case], n_workers)
    got = _run(tpw, HMM_CASES[case], n_workers)
    assert got == want and got[1]
    paths = {row[0]: row[1] for row in got[0].values()}
    if case == "hmm_reducer":
        assert len(paths[0]) == 3 and paths[0][0] == "HUNGRY" and paths[0][-1] == "FULL"
    elif case == "hmm_start_nodes":
        assert paths[0] == ("HUNGRY",)


# ---- the dataset loader ----


@pytest.mark.parametrize("n_workers", [1, 4])
def test_load_mnist_sample_synthetic_equals_reference(n_workers):
    """The synthetic stand-in: 900 / 100 rows of 784 float64 pixels and a
    digit label, the same rows in both packages."""
    def build(pw):
        return pw.ml.datasets.classification.load_mnist_sample(1000, synthetic=True)

    want = _run_tables(jpw, build(jpw), n_workers)
    got = _run_tables(tpw, build(tpw), n_workers)
    assert got == want
    (train, _s, names), (test, _s2, _n2) = got
    assert names == ["data", "label"] and len(train) == 900 and len(test) == 100
    row = next(iter(train.values()))
    assert row[0][2] == (784,) and row[1] in set("0123456789")


def test_load_mnist_sample_raises_without_a_source_and_reads_a_local_file(tmp_path):
    """No network: without ``path`` or ``synthetic`` both raise alike; a
    local ``mnist.npz`` gives the same rows in both."""
    for pw in (jpw, tpw):
        with pytest.raises(NotImplementedError, match="synthetic=True"):
            pw.ml.datasets.classification.load_mnist_sample(10)
    rng = np.random.default_rng(3)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.integers(0, 255, (30, 28, 28), dtype=np.uint8), y_train=rng.integers(0, 10, 30))
    got = {pw: _run_tables(pw, pw.ml.datasets.classification.load_mnist_sample(20, path=str(path)), 1)
           for pw in (jpw, tpw)}
    assert got[tpw] == got[jpw] and [len(t[0]) for t in got[tpw]] == [18, 2]


# ---- the KNN classifier (reference stdlib/ml/classifiers; no reference test) ----


def _seeded_vectors():
    rng = np.random.default_rng(22)
    centers = rng.normal(size=(5, 16)) * 3.0
    labels = rng.integers(0, 5, 240)
    docs = centers[labels] + rng.normal(size=(240, 16))
    q_labels = rng.integers(0, 5, 48)
    queries = centers[q_labels] + rng.normal(size=(48, 16)) * 1.5
    return docs, [f"c{x}" for x in labels], queries, [f"c{x}" for x in q_labels]


def _mnist_vectors():
    rng = np.random.default_rng(0)  # ``load_mnist_sample(2000, synthetic=True)``'s rows, as arrays
    images = rng.integers(0, 255, (2000, 784)).astype(np.float64)
    labels = [str(x) for x in rng.integers(0, 10, 2000)]
    return images[:1800], labels[:1800], images[1800:], labels[1800:]


def _vector_tables(pw, docs, labels, queries, q_labels):
    class S(pw.Schema):
        data: np.ndarray
        label: str

    return (pw.debug.table_from_rows(S, list(zip(docs, labels))),
            pw.debug.table_from_rows(S, list(zip(queries, q_labels))))


def _classify(pw, train, test, d, k):
    kw = {"device": "cpu"} if pw is tpw else {}
    model = pw.ml.classifiers.knn_lsh_classifier_train(train, d=d, **kw)
    predicted = pw.ml.classifiers.knn_lsh_classify(model, train, test, k=k)
    return predicted, pw.ml.utils.classifier_accuracy(predicted, test)


def _plain_votes(docs, labels, queries, k):
    """Per query: (plain majority label, whether f32 may reorder its vote)."""
    d2 = ((queries[:, None, :] - docs[None, :, :]) ** 2).sum(axis=2)
    order = np.argsort(d2, axis=1, kind="stable")[:, : k + 1]
    out = []
    for q, idx in enumerate(order):
        s = d2[q, idx]
        cats = [labels[i] for i in idx[:k]]
        tie = abs(s[k - 1] - s[k]) <= NEAR_TIE * abs(s[k]) or (
            len(set(cats)) == k and abs(s[0] - s[1]) <= NEAR_TIE * abs(s[1]))
        out.append((collections.Counter(cats).most_common(1)[0][0], tie))
    return out


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("data", ["seeded_numpy", "mnist_synthetic_d784"])
def test_knn_classifier_equals_reference(data, n_workers):
    """``knn_lsh_classify(k=3)`` of every test row and ``classifier_accuracy``:
    the labels equal across the packages and to a plain vote away from
    near-ties; the accuracy tables equal where no query is a near-tie, and
    each package's equals a plain count of its own labels."""
    docs, labels, queries, q_labels = _seeded_vectors() if data == "seeded_numpy" else _mnist_vectors()
    votes = _plain_votes(docs, labels, queries, 3)
    got = {}
    for pw in (jpw, tpw):
        train, test = _vector_tables(pw, docs, labels, queries, q_labels)
        (pred, _ps, pnames), (acc, _as, anames) = _run_tables(pw, _classify(pw, train, test, docs.shape[1], 3),
                                                              n_workers)
        got[pw] = (pred, acc, pnames, anames)
    tpred, tacc, pnames, anames = got[tpw]
    jpred, jacc, _, _ = got[jpw]
    assert pnames == ["predicted_label"] and anames == ["cnt", "value"]
    assert set(tpred) == set(jpred) and len(tpred) == len(queries)
    # the test rows' keys in input order: table_from_rows keys rows by position in both packages
    order = _row_keys(len(queries))
    ties = sum(t for _l, t in votes)
    for key, (want, tie) in zip(order, votes):
        if not tie:
            assert tpred[key] == jpred[key] == (want,), (key, tpred[key], jpred[key], want)
    truth = dict(zip(order, q_labels))
    for pred, acc in ((tpred, tacc), (jpred, jacc)):
        hits = collections.Counter(pred[key][0] == truth[key] for key in order)
        assert {row[1]: row[0] for row in acc.values()} == {m: c for m, c in hits.items() if c}
    if not ties:
        assert tacc == jacc
    assert ties <= len(queries) // 20, f"{ties} near-ties: the data no longer separates the neighbours"


def _row_keys(n):
    """The keys ``table_from_rows`` gives rows 0..n-1 (the same in both packages)."""
    class S(tpw.Schema):
        i: int

    state, _stream, _names = _run(tpw, lambda pw: pw.debug.table_from_rows(S, [(i,) for i in range(n)]), 1)
    by_i = {row[0]: key for key, row in state.items()}
    return [by_i[i] for i in range(n)]


def test_classifier_default_device_is_the_card(monkeypatch):
    """The port's trainer places its index as ``KNNIndex`` does: on the
    card unless asked; without one, a run raises instead of falling back."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    docs, labels, queries, q_labels = _seeded_vectors()
    train, test = _vector_tables(tpw, docs[:8], labels[:8], queries[:2], q_labels[:2])
    model = tpw.ml.classifiers.knn_lsh_classifier_train(train, d=16)
    predicted = tpw.ml.classifiers.knn_lsh_classify(model, train, test)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_tables(tpw, [predicted], 1)


def test_predict_asof_now_keeps_the_queries_universe():
    """``ml.utils._predict_asof_now`` wraps a pipeline builder: it refuses
    one with no column reference and, with ``with_queries_universe``,
    keys the result by the queries' table; alike in both packages."""
    got = {}
    for pw in (jpw, tpw):
        t = pw.debug.table_from_markdown("""
          | x
        1 | 2
        2 | 5
        """)
        wrapped = pw.ml.utils._predict_asof_now(lambda col: col.table.select(y=col * 10), with_queries_universe=True)
        with pytest.raises(ValueError, match="column reference"):
            wrapped(3)
        got[pw] = _run(pw, lambda pw: t.select(x=t.x, y=wrapped(t.x).y), 1)
    assert got[tpw] == got[jpw] and sorted(got[tpw][0].values()) == [(2, 20), (5, 50)]


def test_public_names_of_the_ml_stdlib():
    """``pw.ml`` exports the reference's names, of the same kinds, and its
    submodules export theirs."""
    assert tpw.ml.__all__ == jpw.ml.__all__
    for name in jpw.ml.__all__:
        assert callable(getattr(tpw.ml, name)) == callable(getattr(jpw.ml, name)), name
    for sub in ("classifiers", "smart_table_ops", "hmm", "utils", "datasets"):
        jsub, tsub = getattr(jpw.ml, sub), getattr(tpw.ml, sub)
        jnames = {n for n in vars(jsub) if not n.startswith("_")}
        assert {n for n in vars(tsub) if not n.startswith("_")} >= jnames, sub
    assert tpw.ml.datasets.classification.__all__ == jpw.ml.datasets.classification.__all__
    assert [m.name for m in tpw.ml.smart_table_ops.FuzzyJoinNormalization] == [
        m.name for m in jpw.ml.smart_table_ops.FuzzyJoinNormalization]
    assert [m.name for m in tpw.ml.smart_table_ops.FuzzyJoinFeatureGeneration] == [
        m.name for m in jpw.ml.smart_table_ops.FuzzyJoinFeatureGeneration]
