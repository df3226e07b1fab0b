"""The plain reference against a tiny BNN worked by hand, and its control
(batch norm in bfloat16) failing at a size a test run holds."""

import numpy as np
import pytest
import torch

from hepbench import inputs
from hepbench.reference import bnn

# one 2x2x1 image: +1 where the pixel is >= 0.5
X01 = torch.tensor([[[[0.7], [0.2]], [[0.5], [0.1]]]])
# sign(w) of the one 3x3 filter, row by row (0 counts as +1)
W_CONV = [[1, -1, 1], [-1, 1, -1], [1, 1, 0]]
# with the pad value -1 the conv gives [[3, -1], [-1, -1]] by hand
FC_SIGNS = [[1, -1], [1, -1], [-1, -1], [1, -1]]


@pytest.mark.parametrize("gamma,want", [
    # fires where y >= 0.5: [+1, -1, -1, -1] . columns -> [0, 2]
    (1.0, [0, 2]),
    # gamma < 0 fires where y <= 0.5: [-1, +1, +1, +1] -> [0, -2]
    (-1.0, [0, -2]),
])
def test_reference_equals_a_bnn_worked_by_hand(gamma, want):
    layers = bnn.parse(["C1", "S", "FLAT", "FC2"], (2, 2), 1, 2)
    w = torch.tensor(W_CONV, dtype=torch.float32).mul(0.3)
    params = [
        {"w": w.reshape(3, 3, 1, 1)},
        {"gamma": torch.tensor([gamma]), "beta": torch.tensor([0.0]),
         "mean": torch.tensor([0.5]), "var": torch.tensor([1.0])},
        {},
        {"w": torch.tensor(FC_SIGNS, dtype=torch.float32) * 0.1},
    ]
    out = bnn.forward(layers, params, X01, eps=1e-5)
    assert out.dtype == torch.int64
    assert out.tolist() == [want]


def test_pool_and_last_fc_shapes():
    layers = bnn.parse(["C32", "MP4", "S", "FLAT", "FC64", "S", "FC64"],
                       (8, 8), 3, 10)
    assert [x.kind for x in layers] == ["conv", "mp", "step", "flat", "fc",
                                        "step", "fc"]
    assert layers[3].out_shape == (4 * 4 * 32,)
    assert layers[-1].out_shape == (10,)
    with pytest.raises(ValueError):
        bnn.parse(["C32", "MP3"], (8, 8), 3, 10)


TINY = ["C32", "S", "C32", "MP4", "S", "FLAT", "FC64", "S", "FC64"]


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_019])
def test_control_in_bfloat16_fails_the_exact_comparison(seed):
    """The control, the reference with its batch norms in bfloat16, gives
    wrong answers on every seed, so a limit of 0 wrong answers separates
    it from the exact program."""
    layers = bnn.parse(TINY, (8, 8), 3, 10)
    s_w, s_x, *_ = inputs.seeds(seed, 4)
    params = inputs.fp_weights(layers, s_w, "cpu")
    x01 = inputs.images((8, 8, 3), 256, s_x, "cpu")
    exact = bnn.forward(layers, params, x01, eps=1e-5)
    low = bnn.forward(layers, params, x01, eps=1e-5, control=True)
    wrong = int(torch.any(exact != low, dim=1).sum())
    assert wrong > 0


def test_weights_and_images_repeat_from_the_seed():
    layers = bnn.parse(TINY, (8, 8), 3, 10)
    a = inputs.fp_weights(layers, 7, "cpu")
    b = inputs.fp_weights(layers, 7, "cpu")
    c = inputs.fp_weights(layers, 8, "cpu")
    for pa, pb in zip(a, b):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    assert not torch.equal(a[0]["w"], c[0]["w"])
    assert a[0]["w"].shape == (3, 3, 3, 32) and a[6]["w"].shape == (512, 64)
    step = a[1]
    assert torch.all(step["gamma"].abs() >= 0.5) and torch.all(step["var"] > 0)
    x = inputs.images((8, 8, 3), 4, 9, "cpu")
    assert torch.equal(x, inputs.images((8, 8, 3), 4, 9, "cpu"))
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert len(set(inputs.seeds(2**31 + 1, 4))) == 4
    assert np.all(np.array(inputs.seeds(2**33, 4)) < 2**63)
