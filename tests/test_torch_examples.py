"""The PyTorch twins of the classification examples, two epochs each on
the CPU, held to the accuracy bounds of ``tests/test_examples_smoke.py``'s
JAX tests (0.6 for ``examples/classification.py``, 0.4 for
``examples/classification_pan.py``)."""

import pytest
import torch

import examples.classification_torch as ex
from examples.classification_pan_torch import main as pan_main

torch.set_num_threads(1)


@pytest.mark.parametrize("alias,route", [("topk", "dense"),
                                         ("sag", "sparse"),
                                         ("asap", "sparse"),
                                         ("pan", "sparse"),
                                         ("ec", "sparse"),
                                         ("graclus", "sparse"),
                                         ("kmis", "sparse"),
                                         ("lap", "sparse"),
                                         ("mincut", "dense"),
                                         ("mincut_u", "sparse"),
                                         ("bnpool", "dense"),
                                         ("maxcut", "sparse")])
def test_classification_twin_trains(alias, route):
    acc = ex.main(alias, epochs=2, verbose=False, device="cpu")
    assert acc > 0.6
    # top-k and the batched dense family take a dense batch, the other
    # poolers (and the "_u" modes) stay sparse
    assert ex.LAST_ROUTE == route


def test_classification_pan_twin_trains():
    assert pan_main(epochs=2, verbose=False, device="cpu") > 0.4


def test_classification_twin_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        ex.load_dataset("PROTEINS")
    with pytest.raises(NotImplementedError, match="item 9"):
        ex.main("sag", epochs=1, device="cpu", checkpoint_dir="ckpt")
