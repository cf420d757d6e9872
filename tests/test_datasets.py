"""Dataset parsing, history construction, and user-range sharding."""

import numpy as np
import pytest

from heat_cf.data.datasets import ClickDataset, shard_by_user_range
from heat_cf.data.synthetic import synthetic_click_dataset


def test_parse_file(tmp_path):
    p = tmp_path / "train.txt"
    p.write_text("0 5 3 9\n1 2\n2 7 7 1\n")
    ds = ClickDataset.from_file(str(p), max_his=4, use_native=False)
    assert ds.num_users == 3
    assert ds.num_items == 10
    assert ds.train_size == 7
    np.testing.assert_array_equal(
        ds.pairs,
        [[0, 5], [0, 3], [0, 9], [1, 2], [2, 7], [2, 7], [2, 1]],
    )


def test_history_padding_semantics():
    # n < max_his: pad by repeating the last item (datasets.py:51-55).
    ds = ClickDataset.from_user_items(
        [[5, 3], [], [1, 2, 3, 4, 6]], max_his=4
    )
    np.testing.assert_array_equal(ds.his_items[0], [5, 3, 3, 3])
    assert ds.masks[0] == 2
    # empty: zeros, mask 0 (datasets.py:56-60).
    np.testing.assert_array_equal(ds.his_items[1], [0, 0, 0, 0])
    assert ds.masks[1] == 0
    # n >= max_his: a random sample of the items, mask = max_his.
    assert ds.masks[2] == 4
    assert set(ds.his_items[2]) <= {1, 2, 3, 4, 6}
    assert len(set(ds.his_items[2])) == 4  # sampled without replacement


def test_shard_by_user_range_rebases_ids():
    ds = ClickDataset.from_user_items(
        [[0], [1], [2], [3], [4]], max_his=2, num_items=10
    )
    s0 = shard_by_user_range(ds, 2, 0)
    s1 = shard_by_user_range(ds, 2, 1)
    # 5 users over 2 shards -> [0,3) and [3,5) (main.py:51-57 arithmetic).
    assert s0.num_users == 3 and s1.num_users == 2
    np.testing.assert_array_equal(s0.pairs[:, 0], [0, 1, 2])
    np.testing.assert_array_equal(s1.pairs[:, 0], [0, 1])  # re-based
    np.testing.assert_array_equal(s1.pairs[:, 1], [3, 4])
    # item space inherited globally (datasets.py:159).
    assert s1.num_items == 10


def test_native_parser_fuzz(tmp_path):
    """Native parser matches the python parser on messy inputs: CRLF,
    trailing separators, empty lines, duplicate users (last wins), gaps in
    user ids, large random content."""
    pytest.importorskip("heat_cf.native")
    from heat_cf.data.datasets import _parse_lines_numpy
    from heat_cf.native import parse_click_file

    rng = np.random.default_rng(3)
    lines = []
    for u in rng.permutation(200):  # shuffled user order
        if rng.random() < 0.1:
            continue  # gaps in the id space
        items = rng.integers(0, 5000, rng.integers(0, 30))
        sep = " "
        line = sep.join([str(u)] + [str(i) for i in items])
        if rng.random() < 0.2:
            line += " "  # trailing separator
        if rng.random() < 0.2:
            line += "\r"  # CRLF
        lines.append(line)
        if rng.random() < 0.05:
            lines.append("")  # empty line
        if rng.random() < 0.05:
            lines.append(lines[-1] if lines[-1] else line)  # duplicate
    p = tmp_path / "messy.txt"
    p.write_text("\n".join(lines) + "\n")
    native = parse_click_file(str(p))
    py = _parse_lines_numpy(str(p), " ")
    assert len(native) == len(py)
    for a, b in zip(native, py):
        assert list(a) == list(b)


def test_binary_cache_roundtrip(tmp_path):
    ds = ClickDataset.from_user_items(
        [[5, 3], [], [1, 2, 3, 4, 6]], max_his=4, num_items=10
    )
    p = str(tmp_path / "cache.npz")
    ds.save(p)
    back = ClickDataset.load(p)
    np.testing.assert_array_equal(back.pairs, ds.pairs)
    np.testing.assert_array_equal(back.his_items, ds.his_items)
    np.testing.assert_array_equal(back.masks, ds.masks)
    assert back.num_items == 10 and back.max_his == 4
    assert [list(x) for x in back.user_items] == [
        list(x) for x in ds.user_items
    ]


def test_synthetic_dataset_shapes():
    train, test = synthetic_click_dataset(
        num_users=50, num_items=200, clicks_per_user=12, max_his=8, seed=3
    )
    assert train.num_users == 50
    assert train.num_items == 200
    assert train.pairs.shape[1] == 2
    assert train.his_items.shape == (50, 8)
    # every user has at least one test item
    assert all(len(t) >= 1 for t in test.user_items)
    # train/test disjoint per user
    for tr, te in zip(train.user_items, test.user_items):
        assert not (set(tr) & set(te))


def test_load_with_cache(tmp_path):
    from heat_cf.data.datasets import load_with_cache

    p = tmp_path / "train.txt"
    p.write_text("0 5 3\n1 1 2 3\n")
    ds = load_with_cache(str(p), max_his=4, seed=7)
    caches = list(tmp_path.glob("train.txt.heat-*.npz"))
    assert len(caches) == 1
    # Second load hits the cache and reproduces the dataset exactly.
    again = load_with_cache(str(p), max_his=4, seed=7)
    np.testing.assert_array_equal(again.pairs, ds.pairs)
    np.testing.assert_array_equal(again.his_items, ds.his_items)
    # Different parametrization gets its own cache file (history sampling
    # depends on max_his/seed).
    load_with_cache(str(p), max_his=2, seed=7)
    assert len(list(tmp_path.glob("train.txt.heat-*.npz"))) == 2
    # A newer source invalidates the cache.
    import os, time

    time.sleep(0.01)
    p.write_text("0 5\n")
    os.utime(p)
    fresh = load_with_cache(str(p), max_his=4, seed=7)
    assert fresh.train_size == 1
