from hyperbolic_vae_tpu_torch.utils.logging import ColoredFormatter, configure_handler_for_script

__all__ = ["ColoredFormatter", "configure_handler_for_script"]
