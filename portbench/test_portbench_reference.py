"""The plain reference against the port's fused path on the CPU, at a
small image size: the same fractions, the same int8 weights, the same
answers up to the port's float32 softmax."""
import numpy as np
import pytest
import torch

from portbench import cells, check, serving

SEED = 2**31 + 11


@pytest.mark.parametrize("config", ["vgg16-224.zu2", "googlenet-224.zu2"])
@pytest.mark.parametrize("img", [32, 48])
def test_reference_agrees_with_the_fused_path(config, img):
    cfg = dict(cells.config_file(config), img=img, num_classes=10)
    traffic = dict(cells.traffic("offline-q128"), max_batch=4, pool=6)
    layers = cells.reference(cfg["reference"]).layers(img, 10, 3)
    inputs = serving.make_inputs(layers, traffic["pool"], cfg["model_seed"],
                                 SEED, "cpu")
    sut = serving.Served(cfg, traffic, inputs, "cpu")
    sut.server.close()
    pool = inputs.pool.numpy()
    got = sut.session.run_batch([pool[i] for i in range(len(pool))],
                                pad_to=8)
    want, ref = check.reference_answers(layers, inputs.weights(),
                                        inputs.calib, inputs.pool,
                                        inputs.f_img)
    qm = sut.session.qm
    assert {n: qm.f_a[n] for n in ref.f} == ref.f
    for name, w in ref.w.items():
        np.testing.assert_array_equal(qm.weights[name], w.numpy())
        np.testing.assert_array_equal(qm.biases[name], ref.b[name].numpy())
    host = torch.cat([a[sut.output] for a in got])
    numbers = check.compare([(list(range(len(pool))), host)], want, 0)
    assert numbers["malformed"] == 0
    assert numbers["prob_gap"] < 1e-5      # float32 softmax rounding


def test_a_new_layer_kind_is_a_new_file(tmp_path, monkeypatch):
    """An op that ``model.OPS`` lacks comes from ``ops/<op>.py``: here an
    identity before the softmax leaves every answer as it was."""
    from portbench.reference import model, vgg16

    (tmp_path / "same.py").write_text(
        "from portbench.reference import model\n\n\n"
        "class Same(model.Op):\n"
        "    def fraction(self, f, f_ins):\n"
        "        return f_ins[0]\n\n"
        "    def float(self, a, xs, wb):\n"
        "        return xs[0]\n\n"
        "    def fixed(self, a, xs, q):\n"
        "        return xs[0]\n\n\n"
        "OP = Same()\n")
    monkeypatch.setattr(model, "OPS_DIR", tmp_path)
    monkeypatch.setattr(model, "OPS", dict(model.OPS))
    layers = vgg16.layers(32, 10, 3)
    extra = layers[:-1] + [("fc_same", "same", ("fc8",), {}),
                           ("prob", "softmax", ("fc_same",), {})]
    assert model.shapes(extra)["fc_same"] == (1, 1, 10)
    assert model.param_shapes(extra) == model.param_shapes(layers)
    inputs = serving.make_inputs(layers, 4, 5, SEED, "cpu")
    args = (inputs.weights(), inputs.calib, inputs.pool, inputs.f_img)
    want, _ = check.reference_answers(layers, *args)
    got, ref = check.reference_answers(extra, *args)
    assert ref.f["fc_same"] == ref.f["fc8"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown op"):
        model.op("nowhere")
