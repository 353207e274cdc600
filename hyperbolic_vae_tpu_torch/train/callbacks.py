"""Per-epoch figure callbacks.

Port of ``hyperbolic_vae_tpu/train/callbacks.py``; each writes a PNG into
the Trainer's ``log_dir`` through ``MetricLogger.log_image`` on its
cadence, (epoch + 1) % every_n_epochs == 0:

  * ``GenerateCallback``: a reconstruction grid of fixed train inputs
    (inputs above, reconstructions below);
  * ``LatentScatterCallback``: val posterior means coloured by label, on
    +-c^-0.5 (the ball's radius), with the classes' Frechet means; it
    does nothing where matplotlib cannot be imported, as JAX's does;
  * ``LatentGridCallback``: a 2-D latent grid decoded into a mosaic;
  * ``LatentInterpolationCallback``: decodes along geodesics between
    encoded pairs of consecutive classes.

The Trainer calls ``on_epoch_end`` at chunk boundaries with the model's
weights. The stochastic reconstruction draws from a generator seeded
with the epoch (JAX: ``PRNGKey(epoch)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.manifolds.stats import class_means, geodesic
from hyperbolic_vae_tpu_torch.train.evaluation import model_with_params

__all__ = ["GenerateCallback", "LatentGridCallback", "LatentInterpolationCallback",
           "LatentScatterCallback"]


def _to_grid(images: np.ndarray, nrow: int) -> np.ndarray:
    """(N, H, W, C) -> tiled (rows*H, nrow*W, C) grid."""
    n, h, w, c = images.shape
    rows = -(-n // nrow)
    pad = rows * nrow - n
    if pad:
        images = np.concatenate([images, np.zeros((pad, h, w, c), images.dtype)])
    grid = images.reshape(rows, nrow, h, w, c).transpose(0, 2, 1, 3, 4)
    return grid.reshape(rows * h, nrow * w, c)


def _as_images(imgs: np.ndarray) -> Optional[np.ndarray]:
    """Decoder output as (N, H, W, C); flat square vectors as (N, s, s, 1);
    None when a flat vector is not square."""
    if imgs.ndim != 2:
        return imgs
    side = int(np.sqrt(imgs.shape[1]))
    if side * side != imgs.shape[1]:
        return None
    return imgs.reshape(-1, side, side, 1)


def _normalised(imgs: np.ndarray) -> np.ndarray:
    return (imgs - imgs.min()) / max(imgs.max() - imgs.min(), 1e-9)


class GenerateCallback:
    """Reconstruction grid: row 1 inputs, row 2 reconstructions."""

    def __init__(self, inputs: Optional[np.ndarray] = None, every_n_epochs: int = 10, n: int = 8):
        self.inputs = inputs
        self.every_n_epochs = every_n_epochs
        self.n = n

    def on_fit_start(self, trainer, dm):
        if self.inputs is None:
            self.inputs = np.asarray(dm.x_train[: self.n])

    def on_epoch_end(self, trainer, epoch, params, metrics):
        if (epoch + 1) % self.every_n_epochs:
            return
        model = model_with_params(trainer, params)
        x_np = np.asarray(self.inputs, np.float32)
        gen = torch.Generator(device=model.device).manual_seed(epoch)
        with torch.no_grad():
            recon = model.reconstruct(torch.from_numpy(x_np).to(model.device), gen).cpu().numpy()
        if x_np.ndim == 2:  # flat vectors: render as 1 x N strips
            side = int(np.sqrt(x_np.shape[1]))
            if side * side != x_np.shape[1]:
                return
            x_np = x_np.reshape(-1, side, side, 1)
            recon = recon.reshape(-1, side, side, 1)
        lo, hi = x_np.min(), x_np.max()

        def norm(a):
            return (a - lo) / max(hi - lo, 1e-9)

        grid = _to_grid(np.concatenate([norm(x_np), norm(recon)]), nrow=len(x_np))
        trainer.metric_logger.log_image(epoch, "reconstructions", grid)


class LatentScatterCallback:
    """Scatter of val posterior means, range +-c^-0.5 on the ball;
    ``annotate_means`` marks each class's Frechet mean."""

    def __init__(self, every_n_epochs: int = 10, range_xy: Optional[float] = None,
                 max_points: int = 2000, annotate_means: bool = True):
        self.every_n_epochs = every_n_epochs
        self.range_xy = range_xy
        self.max_points = max_points
        self.annotate_means = annotate_means
        self._dm = None

    def on_fit_start(self, trainer, dm):
        self._dm = dm

    def on_epoch_end(self, trainer, epoch, params, metrics):
        if (epoch + 1) % self.every_n_epochs or self._dm is None:
            return
        latent_dim = getattr(trainer.model, "latent_dim", 2)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        mu, labels = trainer.encode_split(self._dm, params, "val")
        if mu.shape[-1] < 2:  # a 1-D latent has no plane to scatter on
            return
        # wider latents: the first two coordinates, as the reference plots
        mu, labels = mu[: self.max_points, :2], labels[: self.max_points]
        ball = getattr(trainer.model, "ball", None)
        r = self.range_xy or (ball.radius if ball is not None else 4.0)
        fig, ax = plt.subplots(figsize=(6, 6))
        names = self._dm.label_names
        for lab in np.unique(labels):
            m = labels == lab
            ax.scatter(mu[m, 0], mu[m, 1], s=4, label=str(names[lab]) if names else str(lab))
        if ball is not None:
            ax.add_patch(plt.Circle((0, 0), ball.radius, fill=False, ls="--", color="gray"))
            if self.annotate_means and len(mu) and latent_dim == 2:
                uniq = np.unique(labels)
                lut = {int(lab): i for i, lab in enumerate(uniq)}
                idx = np.asarray([lut[int(lab)] for lab in labels])
                cm = class_means(ball, torch.from_numpy(mu), torch.from_numpy(idx), len(uniq)).numpy()
                ax.scatter(cm[:, 0], cm[:, 1], marker="x", s=60, c="black", linewidths=1.5,
                           zorder=5)
        ax.set_xlim(-r, r)
        ax.set_ylim(-r, r)
        ax.set_title("Latent space encoding of validation set")
        ax.legend(markerscale=3, fontsize=7, loc="upper right")
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        plt.close(fig)
        trainer.metric_logger.log_image(epoch, "posterior_means", img.astype(np.uint8))


class LatentGridCallback:
    """Decode a 2-D latent grid (projected onto the ball) into a mosaic."""

    def __init__(self, every_n_epochs: int = 20, range_lim: float = 5.0, steps: int = 11):
        self.every_n_epochs = every_n_epochs
        self.range_lim = range_lim
        self.steps = steps

    def on_epoch_end(self, trainer, epoch, params, metrics):
        if (epoch + 1) % self.every_n_epochs:
            return
        model = model_with_params(trainer, params)
        if getattr(model, "latent_dim", None) != 2:
            return
        lin = np.linspace(-self.range_lim, self.range_lim, self.steps)
        zz = torch.from_numpy(np.stack(np.meshgrid(lin, lin), -1).reshape(-1, 2).astype(np.float32))
        ball = getattr(model, "ball", None)
        if ball is not None:
            zz = ball.project(zz)
        with torch.no_grad():
            imgs = _as_images(model.decode(zz.to(model.device)).cpu().numpy())
        if imgs is None:
            return
        trainer.metric_logger.log_image(epoch, "latent_grid",
                                        _to_grid(_normalised(imgs), nrow=self.steps))


class LatentInterpolationCallback:
    """Decode along latent geodesics between encoded val pairs: each row
    walks from one class's first example to the next class's (row pairs
    without labels), on gyro-geodesics on the ball or straight lines for
    flat latents, at any latent width."""

    def __init__(self, every_n_epochs: int = 20, n_pairs: int = 6, steps: int = 12):
        self.every_n_epochs = every_n_epochs
        self.n_pairs = n_pairs
        self.steps = steps
        self._x = None  # (n_pairs, 2, ...) endpoint inputs

    def on_fit_start(self, trainer, dm):
        x, y = np.asarray(dm.x_val), np.asarray(dm.y_val)
        if len(x) < 2:
            return
        if (y >= 0).any():
            classes = np.unique(y[y >= 0])[: self.n_pairs + 1]
            firsts = [x[y == c][0] for c in classes]
            if len(firsts) >= 2:
                ends = [(firsts[i], firsts[i + 1]) for i in range(len(firsts) - 1)]
            else:  # a single labelled class: row pairs
                ends = list(zip(x[0::2], x[1::2]))[: self.n_pairs]
        else:
            ends = list(zip(x[0::2], x[1::2]))[: self.n_pairs]
        self._x = np.stack([np.stack(e) for e in ends])

    def on_epoch_end(self, trainer, epoch, params, metrics):
        if (epoch + 1) % self.every_n_epochs or self._x is None:
            return
        model = model_with_params(trainer, params)
        p = len(self._x)
        t = torch.from_numpy(np.linspace(0.0, 1.0, self.steps, dtype=np.float32)).to(model.device)
        flat_ends = torch.from_numpy(
            np.ascontiguousarray(self._x.reshape((2 * p,) + self._x.shape[2:]), np.float32))
        with torch.no_grad():
            mu = model.posterior_mean(flat_ends.to(model.device)).reshape(p, 2, -1)
            ball = getattr(model, "ball", None)
            if ball is not None:
                z = geodesic(ball, mu[:, :1], mu[:, 1:], t)  # (P, T, D)
            else:
                tt = t[None, :, None]
                z = mu[:, :1] * (1.0 - tt) + mu[:, 1:] * tt
            imgs = model.decode(z.reshape(p * self.steps, -1))
            if hasattr(model, "transform_decoder_output"):
                imgs = model.transform_decoder_output(imgs)
        imgs = _as_images(imgs.cpu().numpy())
        if imgs is None:
            return
        trainer.metric_logger.log_image(epoch, "latent_interpolation",
                                        _to_grid(_normalised(imgs), nrow=self.steps))
