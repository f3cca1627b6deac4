"""The float64 finite-difference check of the imported tiny BERT's
gradients through its fine-tune plan (the graph of
``test_torch_samediff_train.py``, its ``tiny`` fixture and
``_finetune``), in a file of its own: the heaviest port test, so that
another worker of the test run takes it beside that file's."""

from deeplearning4j_tpu_torch.autodiff.gradcheck import (
    check_samediff_gradients)

from test_torch_samediff_train import _finetune, tiny  # noqa: F401


def test_gradients_through_the_plan_pass_finite_differences(tiny):
    model, feeds = tiny
    tsd, _, loss = _finetune("torch", model)
    assert check_samediff_gradients(tsd, feeds, loss, max_per_param=4)
