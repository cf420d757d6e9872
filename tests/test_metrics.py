"""Metric-library tests: hand-computed cases + a per-user loop oracle that
follows the reference formulas (cf/metrics.py:39-158) literally."""

import numpy as np
import pytest

from heat_cf.evaluation.metrics import (
    evaluate_metrics,
    evaluate_sim_matrix,
    parse_metric,
)


def test_parse_metric():
    assert parse_metric("Recall(k=20)") == ("Recall", 20)
    assert parse_metric("NDCG(k=50)") == ("NDCG", 50)
    with pytest.raises(NotImplementedError):
        parse_metric("Bogus(k=3)")
    with pytest.raises(NotImplementedError):
        parse_metric("__import__('os')")


def test_hand_computed_case():
    top = np.array([[3, 1, 7, 2]])
    true = [[1, 2, 9]]
    out = evaluate_metrics(
        ["Recall(k=4)", "Precision(k=4)", "HitRate(k=4)", "MRR(k=4)"],
        top,
        true,
    )
    assert out["Recall(k=4)"] == pytest.approx(2 / (3 + 1e-12))
    assert out["Precision(k=4)"] == pytest.approx(2 / (4 + 1e-12))
    assert out["HitRate(k=4)"] == 1.0
    # hits at ranks 1 (0-based) and 3 -> 1/2 + 1/4
    assert out["MRR(k=4)"] == pytest.approx(0.75)


def test_ndcg_hand_case():
    top = np.array([[5, 1, 2]])
    true = [[1, 2]]
    out = evaluate_metrics(["NDCG(k=3)"], top, true)
    dcg = 1 / np.log(3) + 1 / np.log(4)
    idcg = 1 / np.log(2) + 1 / np.log(3)
    assert out["NDCG(k=3)"] == pytest.approx(dcg / (idcg + 1e-12))


def test_map_hand_case():
    top = np.array([[1, 9, 2, 8]])
    true = [[1, 2]]
    out = evaluate_metrics(["MAP(k=4)"], top, true)
    # hits at ranks 0 and 2: precision 1/1 then 2/3; / num hits 2
    assert out["MAP(k=4)"] == pytest.approx((1.0 + 2 / 3) / 2, rel=1e-9)


# ---- oracle following the reference's per-user code paths ----------------

def _oracle_user(name, k, topk, true):
    topk = list(topk[:k])
    tset = set(true)
    hits = set(true) & set(topk)
    if name == "Recall":
        return len(hits) / (len(true) + 1e-12)
    if name == "NormalizedRecall":
        return len(hits) / min(k, len(true) + 1e-12)
    if name == "Precision":
        return len(hits) / (k + 1e-12)
    if name == "F1":
        p = _oracle_user("Precision", k, topk, true)
        r = _oracle_user("Recall", k, topk, true)
        return 2 * p * r / (p + r + 1e-12)
    if name == "DCG":
        return sum(1 / np.log(2 + i) for i, it in enumerate(topk) if it in tset)
    if name == "NDCG":
        dcg = _oracle_user("DCG", k, topk, true)
        idcg = sum(1 / np.log(2 + i) for i in range(min(k, len(true))))
        return dcg / (idcg + 1e-12)
    if name == "MRR":
        return sum(1 / (i + 1.0) for i, it in enumerate(topk) if it in tset)
    if name == "HitRate":
        return 1.0 if hits else 0.0
    if name == "MAP":
        pos, prec = 0, 0.0
        for i, it in enumerate(topk):
            if it in tset:
                pos += 1
                prec += pos / (i + 1.0)
        return prec / (pos + 1e-12)
    raise AssertionError(name)


ALL_METRICS = [
    "Recall(k=5)",
    "NormalizedRecall(k=5)",
    "Precision(k=5)",
    "F1(k=5)",
    "DCG(k=5)",
    "NDCG(k=5)",
    "MRR(k=5)",
    "HitRate(k=5)",
    "MAP(k=5)",
]


def test_all_metrics_match_per_user_oracle():
    rng = np.random.default_rng(7)
    num_users, num_items, k = 30, 50, 5
    topk = np.stack(
        [rng.choice(num_items, size=8, replace=False) for _ in range(num_users)]
    )
    true = [
        list(rng.choice(num_items, size=rng.integers(1, 10), replace=False))
        for _ in range(num_users)
    ]
    got = evaluate_metrics(ALL_METRICS, topk, true)
    for spec in ALL_METRICS:
        name, kk = parse_metric(spec)
        want = np.mean(
            [_oracle_user(name, kk, topk[u], true[u]) for u in range(num_users)]
        )
        np.testing.assert_allclose(got[spec], want, rtol=1e-9, err_msg=spec)


def test_users_without_test_items_are_excluded():
    top = np.array([[1, 2], [3, 4]])
    out = evaluate_metrics(["HitRate(k=2)"], top, [[1], []])
    assert out["HitRate(k=2)"] == 1.0


def test_sim_matrix_path_masks_train_items():
    sim = np.array([[0.9, 0.8, 0.1], [0.2, 0.7, 0.6]], np.float32)
    train = [[0], []]
    true = [[1], [2]]
    out = evaluate_sim_matrix(["Recall(k=1)"], sim, train, true)
    # user0: item0 masked -> top1 = item1 (hit). user1: top1 = item1 (miss).
    assert out["Recall(k=1)"] == pytest.approx(0.5)


def test_device_metrics_match_host():
    """The on-device metric path (only scalars leave the device) must agree
    with the host path on every metric, including users with no test
    items (excluded from the mean)."""
    from heat_cf.evaluation.metrics import (
        evaluate_metrics_device,
        pad_truth,
    )

    rng = np.random.default_rng(5)
    num_users, num_items = 40, 60
    topk = np.stack(
        [rng.choice(num_items, size=10, replace=False) for _ in range(num_users)]
    )
    true = [
        list(rng.choice(num_items, size=int(n), replace=False))
        for n in rng.integers(0, 12, num_users)
    ]
    specs = [
        "Recall(k=5)", "NormalizedRecall(k=5)", "Precision(k=5)", "F1(k=5)",
        "DCG(k=5)", "NDCG(k=5)", "MRR(k=5)", "HitRate(k=5)", "MAP(k=5)",
        "Recall(k=10)", "NDCG(k=10)",
    ]
    host = evaluate_metrics(specs, topk, true)
    truth, lengths = pad_truth(true)
    dev = evaluate_metrics_device(specs, topk, truth, lengths)
    for s in specs:
        np.testing.assert_allclose(dev[s], host[s], rtol=2e-6, err_msg=s)
