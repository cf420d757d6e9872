"""Config system: reference-schema YAML loading, key mapping, validation."""

import pytest

from heat_cf.config import CFConfig, config_from_dicts, load_config


def test_load_reference_format_configs():
    for name in ("AmazonBooks", "Yelp18", "Gowalla", "Synthetic100M"):
        cfg, ds = load_config(f"benchmarks/{name}/config0.yaml")
        assert cfg.emb_dim in (64, 128)
        assert cfg.l_r == pytest.approx(1e-2)
        assert ds.train_data == "train.txt"
        assert cfg.metrics  # parsed list


def test_amazonbooks_values_match_reference():
    cfg, _ = load_config("benchmarks/AmazonBooks/config0.yaml")
    # cf/benchmarks/AmazonBooks/MF_CCL/configs/config0.yaml values
    assert cfg.emb_dim == 64
    assert cfg.num_negs == 16
    assert cfg.max_his == 100
    assert cfg.tile_size == 512
    assert cfg.refresh_interval == 8192
    assert cfg.clip_val == 1.0
    assert cfg.l2 == pytest.approx(1e-7)
    assert cfg.milestones == [10]
    assert cfg.epochs == 5
    assert cfg.eval_interval == 2
    assert cfg.seed == 2022
    assert cfg.loss == "PairwiseLogisticLoss"


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="bogus"):
        config_from_dicts({"bogus": 1})


def test_reference_subepoch_spelling_accepted():
    cfg = config_from_dicts({"num_subepoches": 3})
    assert cfg.num_subepochs == 3


def test_invalid_values_raise():
    with pytest.raises(ValueError):
        CFConfig(similarity="euclid")
    with pytest.raises(ValueError):
        CFConfig(sgd_mode="adam")
    with pytest.raises(ValueError):
        CFConfig(loss="MSE")
    with pytest.raises(ValueError):
        CFConfig(his_refresh="hourly")


def test_score_mul():
    assert CFConfig(temperature=0.07).score_mul == pytest.approx(1 / 0.07)


def test_overrides_accept_yaml_and_field_names():
    cfg = config_from_dicts(
        {"learning_rate": 0.01},
        overrides={"learning_rate": 0.5, "optimizer": "adam", "emb_dim": 32},
    )
    assert cfg.l_r == 0.5
    assert cfg.optimizer == "adam"
    assert cfg.emb_dim == 32


def test_ccl_parse_order_hazard_warns():
    """loss=CCL + shuffle_mode='none' is the measured collapse combination
    (DESIGN.md 6h) — constructing that config warns; the default shuffle
    does not."""
    import warnings

    from heat_cf.config import CFConfig

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        CFConfig(loss="CosineContrastiveLoss", shuffle_mode="none")
    assert any("collapse" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        CFConfig(loss="CosineContrastiveLoss")
        CFConfig(shuffle_mode="none")
        # Sub-epoch mode re-buckets by item partition — the safe order.
        CFConfig(
            loss="CosineContrastiveLoss",
            shuffle_mode="none",
            num_subepochs=2,
        )
    assert not any("collapse" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        # visit_order='item' IS the measured-best CCL order — no hazard.
        CFConfig(
            loss="CosineContrastiveLoss",
            shuffle_mode="none",
            visit_order="item",
        )
    assert not any("collapse" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        # visit_order='user' forces exactly the collapsing order.
        CFConfig(
            loss="CosineContrastiveLoss",
            shuffle_mode="none",
            visit_order="user",
        )
    assert any("collapse" in str(x.message) for x in w)


def test_visit_order_validation():
    from heat_cf.config import CFConfig

    import pytest

    with pytest.raises(ValueError, match="visit_order"):
        CFConfig(visit_order="zigzag")


# --- the reference-schema config reader (no YAML package needed) -------------

_DATASET = {
    "data_format": "txt",
    "separator": " ",
    "train_data": "train.txt",
    "test_data": "test.txt",
}
_METRICS6 = [
    "Recall(k=20)", "Recall(k=50)", "NDCG(k=20)", "NDCG(k=50)",
    "HitRate(k=20)", "HitRate(k=50)",
]


def _mf_ccl(num_negs, dim, clip, epochs, eval_interval):
    return {
        "num_negs": num_negs,
        "max_his": 100,
        "embedding_dim": dim,
        "neg_sampler": 0,
        "tile_size": 512,
        "refresh_interval": 8192,
        "embedding_dropout": 0,
        "similarity_score": "dot",
        "loss": "PairwiseLogisticLoss",
        "metrics": _METRICS6,
        "optimizer": "sgd",
        "milestones": [10],
        "learning_rate": 0.01,
        "clip_val": clip,
        "embedding_regularizer": 1e-7,
        "net_regularizer": 0,
        "net_dropout": 0,
        "epochs": epochs,
        "eval_interval": eval_interval,
        "seed": 2022,
        "batch_size": 8192,
    }


SHIPPED_CONFIGS = {
    "AmazonBooks": {
        "dataset_config": {"data_dir": "./data/amazon-book", **_DATASET},
        "model_config": _mf_ccl(16, 64, 1.0, 5, 2),
    },
    "Gowalla": {
        "dataset_config": {"data_dir": "./data/gowalla", **_DATASET},
        "model_config": _mf_ccl(64, 128, 0.1, 8, 10),
    },
    "Yelp18": {
        "dataset_config": {"data_dir": "./data/yelp2018", **_DATASET},
        "model_config": _mf_ccl(64, 128, 0.1, 8, 10),
    },
    "Synthetic100M": {
        "dataset_config": {"data_dir": "./data/synthetic100m", **_DATASET},
        "model_config": {
            "num_negs": 16,
            "max_his": 100,
            "embedding_dim": 128,
            "neg_sampler": 1,
            "tile_size": 4096,
            "refresh_interval": 8192,
            "loss": "PairwiseLogisticLoss",
            "metrics": ["Recall(k=20)", "NDCG(k=20)"],
            "milestones": [10],
            "learning_rate": 0.01,
            "clip_val": 1.0,
            "embedding_regularizer": 0,
            "epochs": 1,
            "eval_interval": 10,
            "seed": 2022,
            "batch_size": 65536,
            "his_refresh": "subepoch",
        },
    },
}


@pytest.mark.parametrize("name", sorted(SHIPPED_CONFIGS))
def test_shipped_config_parses_to_literal(name):
    from heat_cf.config import parse_config_text

    with open(f"benchmarks/{name}/config0.yaml") as fh:
        got = parse_config_text(fh.read())
    assert got == SHIPPED_CONFIGS[name]
    # Types, not just values: ints stay ints, 1.e-2 is a float.
    mc = got["model_config"]
    assert type(mc["learning_rate"]) is float
    assert type(mc["batch_size"]) is int


@pytest.mark.parametrize(
    "text,want",
    [
        ("1.e-2", 0.01),
        ("1.e-7", 1e-7),
        ("1e-3", 1e-3),
        ("-5", -5),
        ("0", 0),
        ("' '", " "),
        ('"a b"', "a b"),
        ("'it''s'", "it's"),
        ("[10]", [10]),
        ("[]", []),
        ("['Recall(k=20)', 'NDCG(k=50)']", ["Recall(k=20)", "NDCG(k=50)"]),
        ("[1, 2.5, x]", [1, 2.5, "x"]),
        ("0  # inline comment", 0),
        ("dot # comment", "dot"),
        ("'a # not a comment'", "a # not a comment"),
        ("x#y", "x#y"),
        ("true", True),
        ("False", False),
        ("null", None),
        ("~", None),
        ("bfloat16", "bfloat16"),
        ("PairwiseLogisticLoss", "PairwiseLogisticLoss"),
    ],
)
def test_parse_scalar(text, want):
    from heat_cf.config import parse_scalar

    got = parse_scalar(text)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize(
    "text",
    [
        "a:\n\tb: 1\n",            # tab indentation
        "a: 1\na: 2\n",            # duplicate key
        "- item\n",                # block sequence
        "a: [1, [2]]\n",           # nested flow collection
        "a: 'open\n",              # unterminated quote
        "a: {b: 1}\n",             # flow mapping
        "a:\n    b: 1\n  c: 2\n",  # dedent to a level never opened
    ],
)
def test_parse_config_text_rejects_unsupported(text):
    from heat_cf.config import parse_config_text

    with pytest.raises(ValueError):
        parse_config_text(text)


def test_parse_config_text_nesting_and_comments():
    from heat_cf.config import parse_config_text

    text = (
        "# header\n"
        "outer:\n"
        "    inner:\n"
        "        k: 1   # trailing\n"
        "\n"
        "    j: 'v'\n"
        "top: [a, 'b c']\n"
    )
    assert parse_config_text(text) == {
        "outer": {"inner": {"k": 1}, "j": "v"},
        "top": ["a", "b c"],
    }
