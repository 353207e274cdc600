"""Serving: fixed-shape batched inference over a trained model.

Port of ``hyperbolic_vae_tpu/serve.py``'s ``Inferencer``, with the same
request semantics:

  * Request sizes are BUCKETED to powers of two: sub-batch row counts
    below ``batch_size``, then whole batches up to
    ``max_batches_per_dispatch``; larger requests run as several
    full-cap dispatches. Padding repeats row 0 and is trimmed off.
  * A k-batch dispatch copies its rows to the device once, runs the
    model batch by batch (JAX's ``lax.map``), and copies the outputs
    back once.
  * Each (method, bucket) shape is one "program", counted by
    ``n_programs`` exactly as the JAX engine counts its compiled
    programs. Here a program is an eager call; the bound on the set is
    what lets each be captured once (e.g. as a CUDA graph).
  * ``reconstruct`` is deterministic: decode(encode(x).mean).
  * ``io_dtype`` ("float16"/"bfloat16") halves the host<->device wire for
    data-shaped arrays: inputs are cast on the host before the copy, the
    model computes in f32, data-shaped outputs come back in the wire
    dtype and are restored to float32 numpy.

A model comes from a state_dict (``from_state_dict``: any family, told
by its keys or by ``family=``), from a Trainer's checkpoint directory
(``from_checkpoint``: any family whose checkpoint embeds its
configuration), or is passed in. Image families take and return
channels-last (n, H, W, C) arrays on every endpoint; the Autoencoder's
``encode`` answers its code alone, and neither it nor PvaeMLPVAE has a
``generate``.
Everything runs under ``torch.inference_mode()``. Sharded serving
(``mesh``) and exported program bundles are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from hyperbolic_vae_tpu_torch.device import DeviceLike, resolve_device

_IO_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def model_data_shape(model) -> tuple:
    """Per-sample feature shape of a model's input (its ``data_shape``)."""
    shape = getattr(model, "data_shape", None)
    if not shape:
        raise AttributeError(
            f"{type(model).__name__} exposes no data_shape — pass data_shape explicitly"
        )
    return (shape,) if isinstance(shape, int) else tuple(shape)


def generate_seed(seed: int, batch: int) -> int:
    """Seed of the generator that draws batch ``batch`` of
    ``Inferencer.generate(n, seed)``: the first 63 bits of numpy's
    ``SeedSequence([seed, batch])``. Depends on (seed, batch) alone, so a
    larger n only appends batches."""
    state = np.random.SeedSequence([int(seed), int(batch)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


class Inferencer:
    """Fixed-batch, padded inference endpoint over a model exposing
    ``encode`` / ``posterior_mean`` / ``decode`` (and optionally
    ``generate``).

    ``device`` defaults to ``cuda`` and raises without a card; the model
    is moved there and put in eval mode.
    """

    # endpoints whose input / output arrays are data-shaped
    _DATA_IN = ("encode", "reconstruct")
    _DATA_OUT = ("decode", "reconstruct", "generate")

    def __init__(self, model, batch_size: int = 256,
                 max_batches_per_dispatch: int = 16, io_dtype=None,
                 sub_batch_buckets: bool = True, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        if io_dtype is not None:
            name = str(io_dtype).removeprefix("torch.")
            if name not in _IO_DTYPES:
                raise ValueError(f"io_dtype must be float16 or bfloat16, got {io_dtype}")
            io_dtype = _IO_DTYPES[name]
        self.io_dtype = io_dtype
        self._programs = {}
        # guards the check-then-insert on _programs (request threads and
        # the dispatcher thread may both register programs)
        self._programs_lock = threading.RLock()
        if max_batches_per_dispatch < 1:
            raise ValueError("max_batches_per_dispatch must be >= 1")
        self.max_batches_per_dispatch = int(max_batches_per_dispatch)
        self._buckets = []
        b = 1
        while b < self.max_batches_per_dispatch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_batches_per_dispatch)
        self.sub_batch_buckets = bool(sub_batch_buckets)
        self._row_buckets = []
        if self.sub_batch_buckets:
            r = 1
            while r < self.batch_size:
                self._row_buckets.append(r)
                r *= 2

    @classmethod
    def from_state_dict(cls, path, batch_size: int = 256,
                        max_batches_per_dispatch: int = 16, io_dtype=None,
                        sub_batch_buckets: bool = True, device: DeviceLike = None,
                        data_shape=None, allow_unsafe_pickle: bool = False,
                        **model_config) -> "Inferencer":
        """Serve the model stored at ``path`` (``.npz`` as written by
        ``experiments/export_torch_state_dict.py``, ``.pt``, or the
        reference's Lightning ``.ckpt`` with geoopt's entries): its family
        told by the state_dict's keys or by ``family`` in ``model_config``,
        what a state_dict does not hold (``data_shape``,
        ``manifold_curvature``, ...) from a ``.ckpt``'s
        ``hyper_parameters``, over which ``data_shape`` and
        ``model_config`` take precedence (``interop.model_from_file``).
        Full pickle only with ``allow_unsafe_pickle``
        (``interop.load_torch_state_dict``)."""
        from hyperbolic_vae_tpu_torch.interop import model_from_file

        device = resolve_device(device)
        model = model_from_file(path, device=device, data_shape=data_shape,
                                allow_unsafe_pickle=allow_unsafe_pickle, **model_config)
        return cls(model, batch_size=batch_size,
                   max_batches_per_dispatch=max_batches_per_dispatch,
                   io_dtype=io_dtype, sub_batch_buckets=sub_batch_buckets,
                   device=device)

    @classmethod
    def from_checkpoint(cls, ckpt_dir, name: str = "best", batch_size: int = 256,
                        max_batches_per_dispatch: int = 16, io_dtype=None,
                        sub_batch_buckets: bool = True,
                        device: DeviceLike = None) -> "Inferencer":
        """Serve checkpoint ``name`` (``best``, ``last``, ``ema``, ...) of a
        Trainer's ``checkpoint_dir``: the model is rebuilt from the
        configuration the checkpoint embeds (``train/checkpoint.py``'s
        ``restore_model``), any family with ``hparams()``."""
        from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model

        device = resolve_device(device)
        model, _, _ = restore_model(ckpt_dir, name, device=device)
        return cls(model, batch_size=batch_size,
                   max_batches_per_dispatch=max_batches_per_dispatch,
                   io_dtype=io_dtype, sub_batch_buckets=sub_batch_buckets,
                   device=device)

    def _row_bucket(self, n: int):
        """Smallest sub-batch row bucket >= n (None: use full batches)."""
        for r in self._row_buckets:
            if r >= n:
                return r
        return None

    def _bucket(self, k: int) -> int:
        """Smallest bucket >= k (the caller splits k above the cap)."""
        for b in self._buckets:
            if b >= k:
                return b
        return self.max_batches_per_dispatch

    # ------------------------------------------------------------------ #

    def _wire_in_dtype(self, method: str) -> torch.dtype:
        if self.io_dtype is not None and method in self._DATA_IN:
            return self.io_dtype
        return torch.float32

    def _to_wire(self, method: str, x) -> torch.Tensor:
        """Request array -> host tensor in the wire dtype (bfloat16 has no
        numpy dtype, so that cast happens in torch on the host)."""
        wire = self._wire_in_dtype(method)
        # "W": a read-only buffer (an HTTP body) is copied, not aliased
        if wire == torch.float16:
            return torch.from_numpy(np.require(x, np.float16, ["C", "W"]))
        t = torch.from_numpy(np.require(x, np.float32, ["C", "W"]))
        return t if wire == torch.float32 else t.to(wire)

    @staticmethod
    def _host_restore(t: torch.Tensor) -> np.ndarray:
        """Fetched output -> float32 numpy (half wire dtypes upcast)."""
        return t.float().numpy() if t.dtype != torch.float32 else t.numpy()

    def _apply(self, method: str):
        """One batch on the device: wire-dtype x -> outputs (tuple of
        tensors) in the out dtype."""
        model = self.model
        out_dtype = (self.io_dtype if self.io_dtype is not None
                     and method in self._DATA_OUT else None)

        def cast(out):
            return out if out_dtype is None else out.to(out_dtype)

        if method == "reconstruct":
            def apply(x):
                return (cast(model.decode(model.posterior_mean(x.float()))),)
        elif method == "encode":
            def apply(x):
                out = model.encode(x.float())
                return tuple(cast(a) for a in (out if isinstance(out, tuple) else (out,)))
        elif method == "decode":
            def apply(x):
                return (cast(model.decode(x.float())),)
        else:
            raise ValueError(f"unknown method {method!r}")
        return apply

    def _register(self, key, make):
        with self._programs_lock:
            if key not in self._programs:
                self._programs[key] = make()
            return self._programs[key]

    def _fn(self, method: str):
        return self._register(method, lambda: self._apply(method))

    def _fn_rows(self, method: str, r: int):
        """Program for a sub-batch dispatch of r rows (the base program at
        another shape; the key keeps the accounting)."""
        with self._programs_lock:
            return self._register((method, "r", r), lambda: self._fn(method))

    def _fn_k(self, method: str, k: int):
        """Program for a k-batch dispatch: the base program over each of
        the k batches of the (k, B, ...) stack."""
        assert k > 1, "single-batch requests go through _fn directly"
        with self._programs_lock:
            apply = self._fn(method)

            def make():
                def apply_k(xk):
                    outs = [apply(xb) for xb in xk]
                    return tuple(torch.stack(parts) for parts in zip(*outs))
                return apply_k

            return self._register((method, k), make)

    def _smallest_ready_rows(self, method: str):
        """Smallest row count some already-registered program for
        ``method`` accepts (None if nothing is registered yet)."""
        with self._programs_lock:
            keys = list(self._programs)
        rows = [k[2] for k in keys
                if isinstance(k, tuple) and len(k) == 3 and k[:2] == (method, "r")]
        if rows:
            return min(rows)
        if method in keys:
            return self.batch_size
        return None

    def _fetch(self, out, n_keep: int, k: Optional[int] = None):
        """Device outputs -> float32 numpy, (k, B, ...) flattened, trimmed
        to n_keep rows; a single array for single-output methods."""
        arrs = []
        for a in out:
            a = a.cpu()
            if k is not None:
                a = a.reshape((k * self.batch_size,) + tuple(a.shape[2:]))
            arrs.append(self._host_restore(a)[:n_keep])
        return arrs[0] if len(arrs) == 1 else tuple(arrs)

    def _dispatch(self, method: str, x: np.ndarray, n_keep: int):
        """Run one bucketed dispatch: pad the row count up to bucket*B
        (repeating row 0; padded outputs discarded), run the program,
        fetch once, trim to n_keep rows."""
        b = self.batch_size
        xt = self._to_wire(method, x)
        r = self._row_bucket(xt.shape[0])
        if r is not None:
            pad = r - xt.shape[0]
            if pad:
                xt = torch.cat([xt, xt[:1].expand((pad,) + tuple(xt.shape[1:]))], 0)
            with torch.inference_mode():
                out = self._fn_rows(method, r)(xt.to(self.device))
                return self._fetch(out, n_keep)
        k = self._bucket(max((xt.shape[0] + b - 1) // b, 1))
        pad = k * b - xt.shape[0]
        if pad:
            xt = torch.cat([xt, xt[:1].expand((pad,) + tuple(xt.shape[1:]))], 0)
        with torch.inference_mode():
            xd = xt.to(self.device)
            if k > 1:
                out = self._fn_k(method, k)(xd.reshape((k, b) + tuple(xd.shape[1:])))
                return self._fetch(out, n_keep, k)
            return self._fetch(self._fn(method)(xd), n_keep)

    def _run_padded(self, method: str, x: np.ndarray):
        """Serve a request of any size within the bounded program set:
        full-cap dispatches for the bulk, one bucketed dispatch for the
        remainder."""
        x = np.asarray(x)
        n = x.shape[0]
        if n == 0:
            # run zero rows through an already-registered program (the
            # smallest so far) and trim: an empty request adds no program
            rows = self._smallest_ready_rows(method)
            if rows is None:
                rows = self._row_buckets[0] if self._row_buckets else 1
            x = np.zeros((rows,) + tuple(x.shape[1:]), np.float32)
            return self._dispatch(method, x, 0)
        cap_rows = self.max_batches_per_dispatch * self.batch_size
        if n <= cap_rows:
            return self._dispatch(method, x, n)
        pieces = [self._dispatch(method, x[s:s + cap_rows], min(cap_rows, n - s))
                  for s in range(0, n, cap_rows)]
        if isinstance(pieces[0], tuple):
            return tuple(np.concatenate(parts, axis=0) for parts in zip(*pieces))
        return np.concatenate(pieces, axis=0)

    # ------------------------------------------------------------------ #

    def _gen_fn(self):
        """Program: generator -> one generated batch of B rows."""
        def make():
            model, b, out_dtype = self.model, self.batch_size, self.io_dtype

            def apply(gen):
                out = model.generate(b, generator=gen)
                return out if out_dtype is None else out.to(out_dtype)
            return apply

        return self._register("generate", make)

    def _gen_fn_k(self, k: int):
        assert k > 1
        with self._programs_lock:
            apply = self._gen_fn()
            return self._register(
                ("generate", k), lambda: lambda gens: torch.stack([apply(g) for g in gens])
            )

    def supports_method(self, method: str) -> bool:
        """True when this engine can serve ``method`` (the HTTP front-end
        answers 404 up front otherwise)."""
        if method == "generate":
            return callable(getattr(self.model, "generate", None))
        return method in ("encode", "embed", "decode", "reconstruct")

    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """n decoded latent-prior samples. The same (n, seed) always returns
        the same rows on the same device, and batch i draws from a
        generator seeded with ``generate_seed(seed, i)``, so growing n only
        appends rows. Bucketed like the x-endpoints. (The bits differ
        from the JAX engine's, whose keys are threefry fold-ins.)"""
        b = self.batch_size
        n_batches = max(-(-int(n) // b), 1)
        cap = self.max_batches_per_dispatch
        pieces = []
        with torch.inference_mode():
            for start in range(0, n_batches, cap):
                bucket = self._bucket(min(cap, n_batches - start))
                gens = [
                    torch.Generator(device=self.device).manual_seed(generate_seed(seed, i))
                    for i in range(start, start + bucket)
                ]
                if bucket == 1:
                    out = self._gen_fn()(gens[0])
                else:
                    out = self._gen_fn_k(bucket)(gens)
                    out = out.reshape((bucket * b,) + tuple(out.shape[2:]))
                pieces.append(self._host_restore(out.cpu()))
        return np.concatenate(pieces, axis=0)[: int(n)]

    # ------------------------------------------------------------------ #

    def encode(self, x: np.ndarray):
        """Posterior (mean, scale); the mean is the latent embedding."""
        return self._run_padded("encode", x)

    def decode(self, z: np.ndarray):
        return self._run_padded("decode", z)

    def reconstruct(self, x: np.ndarray):
        return self._run_padded("reconstruct", x)

    def embed(self, x: np.ndarray) -> np.ndarray:
        """Poincare-ball embedding (posterior mean) as a single array."""
        out = self.encode(x)
        return out[0] if isinstance(out, (tuple, list)) else out

    @property
    def n_programs(self) -> int:
        """Number of distinct (method, bucket) programs run so far
        (bounded: at most len(row_buckets)+len(buckets)+1 per method)."""
        return len(self._programs)

    def warmup(self, data_shape: Optional[tuple] = None,
               methods: Optional[tuple] = None):
        """Run every (method, bucket) program once before traffic arrives,
        so the kernels are built and loaded and the allocator holds the
        largest bucket's memory."""
        if methods is None:
            methods = ("reconstruct", "encode", "decode") + (
                ("generate",) if hasattr(self.model, "generate") else ()
            )
        shape = tuple(data_shape) if data_shape else model_data_shape(self.model)
        for method in methods:
            if method == "generate":
                for k in self._buckets:
                    self.generate(k * self.batch_size)
                continue
            feat = ((int(self.model.latent_dim),) if method == "decode" else shape)
            for r in self._row_buckets:
                getattr(self, method)(np.zeros((r,) + feat, np.float32))
            for k in self._buckets:
                getattr(self, method)(np.zeros((k * self.batch_size,) + feat, np.float32))
        return self
