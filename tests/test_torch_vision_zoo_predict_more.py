"""Inception v3 (its max pools) and AlexNet of the port's vision
zoo in predict mode against the JAX package on the CPU, through
``test_torch_vision_zoo_predict.predict_pair`` (its module docstring: no
activation or pool substitutes, logits within 1e-4 of the largest)."""
import pytest

from test_torch_vision_zoo_predict import _zoo, predict_pair

#: name: (builder, input side): full width; Inception v3 on 299x299, the
#: input its 8x8 average pool needs
FAMILIES = {
    "inception_v3": (_zoo("inception_v3", classes=10), 299),
    "alexnet": (_zoo("alexnet"), 64),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_predict_forward_real_activations(name):
    """:func:`predict_pair` on each family of :data:`FAMILIES`."""
    predict_pair(name, *FAMILIES[name])
