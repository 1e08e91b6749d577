"""Unsupervised pretraining workflows over the MNIST784 loader (the JAX
package's ``znicz/samples/mnist_rbm.py``):

* :class:`MnistRBMWorkflow` — a Bernoulli RBM trained by CD-k (the CD
  statistics come from autograd of the free-energy difference,
  ``znicz.rbm``); the decision tracks the reconstruction MSE per epoch;
* :class:`MnistAEWorkflow` — a tied-weight autoencoder: an
  All2AllSigmoid encoder and an All2AllDeconvSigmoid decoder that
  shares the encoder's weights, MSE against the input.

Both leave pretrained weights a supervised workflow can adopt by
Vector assignment.  Run::

    python -m veles_tpu_torch veles_tpu_torch/znicz/samples/mnist_rbm.py \
        --device cpu root.mnist_rbm.max_epochs=2
"""

from ...accelerated_units import AcceleratedWorkflow
from ...config import root, get as config_get
from ...plumbing import Repeater
from ..all2all import All2AllSigmoid
from ..decision import DecisionGD
from ..evaluator import EvaluatorMSE
from ..gd import GDSigmoid
from ..rbm import (RBM, GDRBM, EvaluatorRBM, All2AllDeconvSigmoid,
                   GDA2ADeconvSigmoid)
from .mnist import MnistLoader


class MnistRBMWorkflow(AcceleratedWorkflow):
    def __init__(self, workflow, n_hidden=128, minibatch_size=100,
                 learning_rate=0.05, gradient_moment=0.5, cd_k=1,
                 max_epochs=5, loader_cls=MnistLoader, **kwargs):
        super(MnistRBMWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_cls(self, minibatch_size=minibatch_size)
        self.loader.link_from(self.repeater)

        self.rbm = RBM(self, output_sample_shape=(n_hidden,),
                       cd_k=cd_k, weights_stddev=0.01)
        self.rbm.link_from(self.loader)
        self.rbm.input = self.loader.minibatch_data
        self.rbm.mask = self.loader.minibatch_mask

        self.evaluator = EvaluatorRBM(self)
        self.evaluator.link_from(self.rbm)
        self.evaluator.input = self.rbm.reconstruction
        self.evaluator.target = self.loader.minibatch_data
        self.evaluator.mask = self.loader.minibatch_mask
        self.evaluator.minibatch_class_vec = \
            self.loader.minibatch_class_vec

        self.decision = DecisionGD(self, max_epochs=max_epochs,
                                   evaluator=self.evaluator)
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")

        self.gd = GDRBM(self, target=self.rbm,
                        learning_rate=learning_rate,
                        gradient_moment=gradient_moment)
        self.gd.link_from(self.decision)

        self.repeater.link_from(self.gd)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.gd)
        self.end_point.gate_block = ~self.decision.complete
        self.forwards = [self.rbm]


class MnistAEWorkflow(AcceleratedWorkflow):
    def __init__(self, workflow, n_hidden=128, minibatch_size=100,
                 learning_rate=0.1, gradient_moment=0.9,
                 max_epochs=5, loader_cls=MnistLoader, **kwargs):
        super(MnistAEWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = loader_cls(self, minibatch_size=minibatch_size)
        self.loader.link_from(self.repeater)

        self.encoder = All2AllSigmoid(
            self, output_sample_shape=(n_hidden,),
            weights_stddev=0.05, name="encoder")
        self.encoder.link_from(self.loader)
        self.encoder.input = self.loader.minibatch_data

        self.decoder = All2AllDeconvSigmoid(
            self, get_weights_from=self.encoder, name="decoder")
        self.decoder.link_from(self.encoder)
        self.decoder.input = self.encoder.output

        self.evaluator = EvaluatorMSE(self, root=True)
        self.evaluator.link_from(self.decoder)
        self.evaluator.input = self.decoder.output
        self.evaluator.target = self.loader.minibatch_data
        self.evaluator.mask = self.loader.minibatch_mask
        self.evaluator.minibatch_class_vec = \
            self.loader.minibatch_class_vec

        self.decision = DecisionGD(self, max_epochs=max_epochs,
                                   evaluator=self.evaluator)
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "last_minibatch",
            "epoch_ended", "epoch_number")

        gd_kw = {"learning_rate": learning_rate,
                 "gradient_moment": gradient_moment}
        self.gd_decoder = GDA2ADeconvSigmoid(
            self, target=self.decoder, **gd_kw)
        self.gd_decoder.link_from(self.decision)
        self.gd_encoder = GDSigmoid(self, target=self.encoder, **gd_kw)
        self.gd_encoder.link_from(self.gd_decoder)

        self.repeater.link_from(self.gd_encoder)
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.gd_encoder)
        self.end_point.gate_block = ~self.decision.complete
        self.forwards = [self.encoder, self.decoder]


def run(load, main):
    """The command line's hook (``root.mnist_rbm.*`` overrides)."""
    load(MnistRBMWorkflow,
         n_hidden=config_get(root.mnist_rbm.n_hidden, 128),
         minibatch_size=config_get(root.mnist_rbm.minibatch_size, 100),
         learning_rate=config_get(root.mnist_rbm.learning_rate, 0.05),
         max_epochs=config_get(root.mnist_rbm.max_epochs, 5))
    main()
