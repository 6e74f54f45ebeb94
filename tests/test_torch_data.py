"""The port's data layer against the JAX package's, on the CPU: the
dataset loaders give bit-identical arrays (the same numpy draws), the
transformers and ``Dataset.from_csv`` equal columns, and the utility
helpers the same values.
"""

import numpy as np
import pytest

from distkeras_tpu import utils as jax_utils
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.data import transformers as jax_tf
from distkeras_tpu.data.dataset import Dataset as JaxDataset

from distkeras_tpu_torch import utils
from distkeras_tpu_torch.data import Dataset, datasets, transformers as tf

LOADERS = {
    "mnist_flat": ("load_mnist", dict(n_train=64)),
    "mnist_image_label_noise": ("load_mnist", dict(n_train=64, flat=False,
                                                   label_noise=0.2,
                                                   noise=0.5, seed=3)),
    "cifar10": ("load_cifar10", dict(n_train=32, seed=1)),
    "imdb": ("load_imdb", dict(n_train=40, seq_len=30, vocab_size=500)),
    "lm_corpus": ("load_lm_corpus", dict(n_train=24, seq_len=16,
                                         vocab_size=11, seed=2)),
    "imagenet_subset": ("load_imagenet_subset", dict(n_train=20,
                                                     num_classes=4,
                                                     image_size=16)),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loaders_are_bit_identical(name):
    fn, kw = LOADERS[name]
    got = getattr(datasets, fn)(**kw)
    ref = getattr(jax_datasets, fn)(**kw)
    assert got[2] == ref[2]
    for g, r in zip(got[:2], ref[:2]):
        assert g.column_names == r.column_names
        for c in r.column_names:
            assert g[c].dtype == r[c].dtype
            np.testing.assert_array_equal(g[c], r[c])


def test_synthetic_images_share_templates_across_splits():
    x1, y1 = datasets._synthetic_images(8, (4, 4), 3, seed=5, split_seed=0)
    x2, y2 = jax_datasets._synthetic_images(8, (4, 4), 3, seed=5,
                                            split_seed=0)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    assert x1.dtype == np.float32 and y1.dtype == np.int64


def _table():
    rng = np.random.default_rng(0)
    return {"features": rng.integers(0, 256, size=(12, 16)).astype(
        np.float32), "label": rng.integers(0, 4, size=12),
        "prediction": rng.dirichlet(np.ones(4), size=12).astype(np.float32),
        "score": rng.uniform(size=(12, 1)).astype(np.float32)}


TRANSFORMERS = {
    "one_hot": lambda m: m.OneHotTransformer(4),
    "min_max": lambda m: m.MinMaxTransformer(n_min=-1.0, n_max=1.0),
    "reshape": lambda m: m.ReshapeTransformer("features", "image", (4, 4, 1)),
    "dense": lambda m: m.DenseTransformer(),
    "label_index": lambda m: m.LabelIndexTransformer(4),
    "label_index_binary": lambda m: m.LabelIndexTransformer(
        input_col="score", activation_threshold=0.4),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_transformers_match_jax(name):
    got = TRANSFORMERS[name](tf).transform(Dataset(_table()))
    ref = TRANSFORMERS[name](jax_tf)(JaxDataset(_table()))
    assert got.column_names == ref.column_names
    for c in ref.column_names:
        assert got[c].dtype == ref[c].dtype
        np.testing.assert_array_equal(got[c], ref[c])


def test_one_hot_refuses_out_of_range_labels():
    with pytest.raises(ValueError, match="labels"):
        tf.OneHotTransformer(3).transform(Dataset(_table()))


@pytest.mark.parametrize("label_first", [True, False])
def test_from_csv_matches_jax(tmp_path, label_first):
    rng = np.random.default_rng(1)
    rows = np.concatenate([rng.integers(0, 10, size=(6, 1)),
                           rng.integers(0, 256, size=(6, 5))], axis=1)
    if not label_first:
        rows = rows[:, ::-1]
    lines = [",".join(str(v) for v in r) for r in rows]
    lines[2] = lines[2].replace(",", ", ", 1) + "\r"   # spaces, CRLF
    lines[3] = lines[3] + ",1.5e1x"   # strtof's numeric prefix
    lines[4] = lines[4] + ",label"    # a non-numeric token is skipped
    path = tmp_path / "rows.csv"
    path.write_text("\n".join(lines) + "\n")
    # one value too many (the 1.5e1 prefix): both refuse alike
    for cls in (Dataset, JaxDataset):
        with pytest.raises(ValueError, match="divisible"):
            cls.from_csv(str(path), 5, label_first=label_first)
    lines[3] = lines[3].rsplit(",", 1)[0]
    path.write_text("\n".join(lines) + "\n")
    got = Dataset.from_csv(str(path), 5, label_first=label_first)
    ref = JaxDataset.from_csv(str(path), 5, label_first=label_first)
    for c in ("features", "label"):
        assert got[c].dtype == ref[c].dtype
        np.testing.assert_array_equal(got[c], ref[c])


def test_utility_helpers_match_jax():
    ds, jds = Dataset(_table()), JaxDataset(_table())
    np.testing.assert_array_equal(utils.shuffle(ds, 3)["label"],
                                  jax_utils.shuffle(jds, 3)["label"])
    np.testing.assert_array_equal(utils.to_dense_vector(2, 5),
                                  jax_utils.to_dense_vector(2, 5))
    with pytest.raises(ValueError):
        utils.to_dense_vector(5, 5)
    row = {"a": 1}
    assert utils.new_dataset_row(row, "b", 2) == \
        jax_utils.new_dataset_row(row, "b", 2)
    assert row == {"a": 1}
    assert utils.new_dataframe_row is utils.new_dataset_row
    hist = [{"loss": 1.0}, 3.0, {"loss": 2.0}]
    assert utils.history_average(hist) == jax_utils.history_average(hist)
    assert np.isnan(utils.history_average([]))


def test_uniform_weights_redraws_params_and_keeps_state():
    """The draws come from torch's generator (not JAX's), so the law is
    held: same shapes and dtypes, inside [-bound, bound], seeded."""
    variables = {"params": [{"kernel": np.ones((3, 4), np.float32)},
                            {"bias": np.zeros(4, np.float32)}],
                 "state": [{}, {"mean": np.arange(4.0, dtype=np.float32)}]}
    out = utils.uniform_weights(variables, seed=1, bound=0.1)
    again = utils.uniform_weights(variables, seed=1, bound=0.1)
    other = utils.uniform_weights(variables, seed=2, bound=0.1)
    for a, b, c, ref in zip(*(v["params"] for v in (out, again, other,
                                                     variables))):
        for k in ref:
            assert a[k].shape == ref[k].shape and a[k].dtype == ref[k].dtype
            assert np.all(np.abs(a[k]) <= 0.1) and np.any(a[k] != 0)
            np.testing.assert_array_equal(a[k], b[k])
            assert not np.array_equal(a[k], c[k])
    assert out["state"] is variables["state"]
