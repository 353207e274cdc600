"""The Trainer's default step: autograd through the model's loss, then
Riemannian Adam."""


def fns(model) -> dict:
    return {}
