"""The recurrent and quaternion nets on the CPU against azoom: one train
step of the CRN (the causal form of crn_causal), the BLSTM
(azoom_torch.models.blstm) and the QCNN (azoom_torch.models.qcnn) against
azoom.train.loop.make_train_step, at the bounds of
tests/test_torch_train_nets.py (``-s`` prints each measured value); the
bidirectional CRN's and the causal BLSTM's forwards against the reference's
apply (1e-5); the serving modules of the twins' weights (1e-5); and the QCNN's refusals."""

import jax
import numpy as np
import pytest
import torch

from azoom.models.blstm import BLSTMMaskNet as JaxBLSTM
from azoom.models.crn import CRNMaskNet as JaxCRN
from azoom.models.qcnn import QCNNMaskNet as JaxQCNN
from azoom_torch.models import trainable
from azoom_torch.models.blstm import BLSTMMaskNet
from azoom_torch.models.convert import crn_from_flax, from_flax
from azoom_torch.models.qcnn import QCNNMaskNet, QuaternionConv
from test_torch_train_nets import assert_step_matches, batch, port_step, reference_step

NETS = {
    "crn_causal": (lambda: JaxCRN(base=4, hidden=16), lambda: trainable.CRNMaskNet(base=4, hidden=16),
                   2),
    "blstm": (lambda: JaxBLSTM(hidden=16), lambda: BLSTMMaskNet(hidden=16), 2),
    "qcnn": (lambda: JaxQCNN(base=2), lambda: QCNNMaskNet(base=2), 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(NETS))
def test_one_train_step_matches_reference(name):
    make_ref, make_port, channels = NETS[name]
    x, y = batch(channels)
    ref = reference_step(make_ref(), x, y)
    assert_step_matches(name, ref, port_step(make_port(), ref, x, y))


@pytest.mark.parametrize("name", ["crn_bidirectional", "blstm_causal"])
def test_forwards_match_reference_apply(name):
    jm, net = {
        "crn_bidirectional": (JaxCRN(base=4, hidden=16, unidirectional=False),
                              trainable.CRNMaskNet(base=4, hidden=16, unidirectional=False)),
        "blstm_causal": (JaxBLSTM(hidden=16, unidirectional=True),
                         BLSTMMaskNet(hidden=16, unidirectional=True)),
    }[name]
    x, _ = batch(2, seed=2)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), x))
    net.build(x.shape).load_variables(v)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - ref).max())
    print(f"[forward] {name}: {err:.2e}")
    assert err < 1e-5


def test_serving_copies_are_the_eval_forward():
    """A twin's weights served through its ``serving_spec()`` (the float
    ``from_flax`` / ``crn_from_flax`` module) give its ``eval()`` forward
    within 1e-5; the BLSTM and the QCNN serve in their own module."""
    x, _ = batch(4, seed=3)
    for net in (trainable.FreqPreservingUNet(base=2), trainable.TPUFPU(base=16, fold=4, bneck=2),
                trainable.CRNMaskNet(base=4, hidden=16)):
        c = 4 if isinstance(net, trainable.TPUFPU) else 2
        net.init(torch.Generator().manual_seed(0), (1,) + x.shape[1:3] + (c,))
        cls, kw = net.serving_spec()
        if isinstance(net, trainable.CRNMaskNet):
            serving = crn_from_flax(net.variables(), kw, "cpu")
        else:
            serving = from_flax(cls, net.variables(), kw, False, "cpu")
        assert not serving.training and not hasattr(net, "serving")
        xin = torch.from_numpy(x[..., :c].copy())
        with torch.no_grad():
            err = float((serving(xin) - net.eval()(xin)).abs().max())
        print(f"[serving] {type(net).__name__}: {err:.2e}")
        assert err < 1e-5
    for net in (QCNNMaskNet(base=2), BLSTMMaskNet(hidden=8)):
        assert not hasattr(net, "serving_spec") and not hasattr(net, "serving")


def test_qcnn_refuses_other_features():
    with pytest.raises(ValueError, match="4-channel physics"):
        QCNNMaskNet(base=2).build((1, 65, 16, 2))
    with pytest.raises(ValueError, match="4k channels"):
        QuaternionConv(1, 2)(torch.zeros(1, 3, 4, 6))
