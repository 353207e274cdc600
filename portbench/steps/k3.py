"""K3: the flagship's fused training step as the Trainer's
``train_step_fn``, and K2, the fused loss, for its val pass."""


def fns(model) -> dict:
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    return {"loss_fn": ff.make_fused_loss_fn(model), "train_step_fn": ff.make_fused_train_step(model)}
