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
Everything runs under ``torch.inference_mode()``.

``mesh`` (``parallel.make_mesh``) makes every call a collective: each
rank of the mesh calls it with the same rows, computes its share of
every batch (the batch size is rounded up to a multiple of the data axis,
as JAX rounds it, and sub-batch row buckets are off) and the outputs are
all-gathered, so every rank returns the whole answer. ``generate`` draws
each batch's eps whole and decodes the rank's rows of it.

Exported bundles (JAX ``export_programs`` / ``ExportedInferencer``):
``Inferencer.export_programs(out_dir)`` writes each (method, dispatch
bucket) and (method, row bucket) as one ``torch.export`` program per
device type in ``platforms``, a function of ``(params, x)`` traced
through ``torch.func.functional_call``, so the parameters are saved once
(``params.pt``, weights-only, dtype-preserving) beside a JSON manifest
with JAX's keys. ``ExportedInferencer.load(dir)`` serves the bundle with
the same bucketing front-end and no model class: it needs ``torch`` and
this package's ``ops`` module, which registers K1's op
(``torch.ops.hvae_torch.gyroplane_distances``) that the programs call.
``generate``'s programs take the batch's standard-normal draws as input;
the bundle draws them from the live engine's generators, in its order,
so its rows are the live engine's.
"""

from __future__ import annotations

import copy
import json
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

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
    mesh = None  # a bundle's engine serves unsharded

    def __init__(self, model, batch_size: int = 256,
                 max_batches_per_dispatch: int = 16, io_dtype=None,
                 sub_batch_buckets: bool = True, device: DeviceLike = None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        self.model = model.to(self.device).eval()
        # the feature shapes of warmup's and export's inputs
        self.latent_dim = int(model.latent_dim)
        self.data_shape = model_data_shape(model) if getattr(model, "data_shape", None) else None
        self.batch_size = int(batch_size)
        if mesh is not None:
            n_data = mesh.shape["data"]
            self.batch_size = -(-self.batch_size // n_data) * n_data
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
        # sub-batch rows cannot split evenly over a mesh's data axis
        self.sub_batch_buckets = bool(sub_batch_buckets) and mesh is None
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
                        device: DeviceLike = None, mesh=None) -> "Inferencer":
        """Serve checkpoint ``name`` (``best``, ``last``, ``ema``, ...) of a
        Trainer's ``checkpoint_dir``: the model is rebuilt from the
        configuration the checkpoint embeds (``train/checkpoint.py``'s
        ``restore_model``), any family with ``hparams()``; ``mesh`` as
        ``Inferencer(mesh=)`` (the device then the mesh's rank's)."""
        from hyperbolic_vae_tpu_torch.train.checkpoint import restore_model

        device = resolve_device(device if mesh is None or device is not None else mesh.device)
        model, _, _ = restore_model(ckpt_dir, name, device=device)
        return cls(model, batch_size=batch_size,
                   max_batches_per_dispatch=max_batches_per_dispatch,
                   io_dtype=io_dtype, sub_batch_buckets=sub_batch_buckets,
                   device=device, mesh=mesh)

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

    def _apply(self, method: str, model=None):
        """One batch on the device: wire-dtype x -> outputs (tuple of
        tensors) in the out dtype (on ``model``, default the engine's)."""
        model = self.model if model is None else model
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
        elif method == "generate":
            def apply(eps):  # the batch's standard-normal draws (B, latent)
                return (cast(model.generate_from_eps(eps)),)
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
            return self._register((method, k), lambda: _over_batches(apply))

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
                xk = xd.reshape((k, b) + tuple(xd.shape[1:]))
                out = self._on_shares(self._fn_k(method, k), xk, axis=1)
                return self._fetch(out, n_keep, k)
            return self._fetch(self._on_shares(self._fn(method), xd, axis=0), n_keep)

    def _on_shares(self, fn, x: torch.Tensor, axis: int):
        """``fn(x)``; under a mesh ``fn`` of this rank's rows of each batch
        (the batch along ``axis``), the outputs all-gathered in row order."""
        if self.mesh is None:
            return fn(x)
        from hyperbolic_vae_tpu_torch.parallel.data_parallel import gather_even
        from hyperbolic_vae_tpu_torch.parallel.mesh import share

        n, i = self.mesh.shape["data"], self.mesh.coord("data")
        lo, hi = share(x.shape[axis], n, i)
        out = fn(x.narrow(axis, lo, hi - lo))
        return tuple(gather_even(a, self.mesh.group("data"), n, axis) for a in out)

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

    def _draws(self, gen: torch.Generator) -> torch.Tensor:
        """One batch's standard-normal draws from ``gen``, as the model's
        ``generate`` takes them."""
        return torch.randn((self.batch_size, self.latent_dim), generator=gen,
                           device=self.device, dtype=torch.float32)

    def supports_method(self, method: str) -> bool:
        """True when this engine can serve ``method`` (the HTTP front-end
        answers 404 up front otherwise)."""
        if method == "generate":
            return callable(getattr(self.model, "generate_from_eps", None))
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
                eps = [
                    self._draws(torch.Generator(device=self.device)
                                .manual_seed(generate_seed(seed, i)))
                    for i in range(start, start + bucket)
                ]
                if bucket == 1:
                    out = self._on_shares(self._fn("generate"), eps[0], axis=0)[0]
                else:
                    out = self._on_shares(self._fn_k("generate", bucket), torch.stack(eps),
                                          axis=1)[0]
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
            methods = tuple(m for m in ("reconstruct", "encode", "decode", "generate")
                            if self.supports_method(m))
        shape = self._data_shape(data_shape)
        for method in methods:
            if method == "generate":
                for k in self._buckets:
                    self.generate(k * self.batch_size)
                continue
            feat = (self.latent_dim,) if method == "decode" else shape
            for r in self._row_buckets:
                getattr(self, method)(np.zeros((r,) + feat, np.float32))
            for k in self._buckets:
                getattr(self, method)(np.zeros((k * self.batch_size,) + feat, np.float32))
        return self

    def _data_shape(self, data_shape: Optional[tuple] = None) -> tuple:
        """``data_shape`` if given, else the engine's."""
        if data_shape:
            return tuple(data_shape)
        if self.data_shape is None:
            raise AttributeError(
                f"{type(self.model).__name__} exposes no data_shape — pass data_shape explicitly")
        return self.data_shape

    # ------------------------------------------------------------------ #

    def export_programs(self, out_dir, methods: tuple = ("encode", "decode", "reconstruct"),
                        data_shape: Optional[tuple] = None, latent_dim: Optional[int] = None,
                        platforms: tuple = ("cpu", "cuda")):
        """Write the bucketed program set as a serving bundle in
        ``out_dir``: ``<method>_k<k>.<platform>.pt2`` for each dispatch
        bucket, ``<method>_r<r>.<platform>.pt2`` for each row bucket
        (not for ``generate``), ``params.pt`` and ``manifest.json``.
        ``platforms`` names the device types the bundle holds programs
        for; ``"cuda"`` needs the card. Programs are traced under
        ``torch.no_grad()`` at the shapes of their bucket."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        methods = tuple(methods)
        for method in methods:
            if not self.supports_method(method) or method == "embed":
                raise ValueError(f"cannot export method {method!r} for {type(self.model).__name__}")
        data_shape = self._data_shape(data_shape)
        latent_dim = int(latent_dim or self.latent_dim)
        state = {k: v.detach() for k, v in self.model.state_dict().items()}
        feat = {m: ((latent_dim,) if m in ("decode", "generate") else data_shape) for m in methods}
        for platform in platforms:
            device = resolve_device(platform)
            model = self.model if device == self.device else _model_on(self.model, device)
            params = {k: v.to(device) for k, v in state.items()}
            shapes = []
            for method in methods:
                wire = torch.float32 if method == "generate" else self._wire_in_dtype(method)
                shapes += [(f"{method}_k{k}", method, k, (k, self.batch_size) if k > 1
                            else (self.batch_size,), wire) for k in self._buckets]
                if method != "generate":
                    shapes += [(f"{method}_r{r}", method, None, (r,), wire)
                               for r in self._row_buckets]
            for stem, method, k, lead, wire in shapes:
                # one batch (rows at any count) or a (k, B, ...) stack, as
                # the live _fn / _fn_k
                fn = self._apply(method, model)
                fn = _over_batches(fn) if k and k > 1 else fn
                x = torch.zeros(lead + feat[method], dtype=wire, device=device)
                with torch.no_grad():
                    prog = torch.export.export(_ParamsProgram(model, fn), (params, x))
                torch.export.save(prog, out / f"{stem}.{device.type}.pt2")
        torch.save({k: v.cpu() for k, v in state.items()}, out / "params.pt")
        (out / "manifest.json").write_text(json.dumps({
            "batch_size": self.batch_size,
            "max_batches_per_dispatch": self.max_batches_per_dispatch,
            "buckets": self._buckets,
            "row_buckets": self._row_buckets,
            "methods": list(methods),
            "data_shape": list(data_shape),
            "latent_dim": latent_dim,
            "platforms": [resolve_device(p).type for p in platforms],
            "io_dtype": None if self.io_dtype is None else str(self.io_dtype).removeprefix("torch."),
            "param_paths": list(state),
            "param_dtypes": [str(v.dtype).removeprefix("torch.") for v in state.values()],
            "param_shapes": [list(v.shape) for v in state.values()],
        }))
        return out


def _over_batches(apply):
    """``apply`` (one batch -> a tuple of outputs) over each batch of a
    (k, B, ...) stack, the outputs stacked (JAX's ``lax.map``)."""
    return lambda xk: tuple(torch.stack(parts) for parts in zip(*[apply(xb) for xb in xk]))


def _model_on(model, device: torch.device):
    """A copy of ``model`` on ``device`` (the bundle's programs of another
    device type than the live engine's)."""
    return copy.deepcopy(model).to(device)


class _ParamsProgram(torch.nn.Module):
    """``fn(x)`` on ``model`` as a function of ``(params, x)``: the model's
    state is an input of the traced program, swapped in for the call as
    ``torch.func.functional_call`` swaps it, so an exported program holds
    no weights of its own."""

    def __init__(self, model, fn):
        super().__init__()
        # not a registered submodule: its tensors are not the program's
        object.__setattr__(self, "model", model)
        self.fn = fn

    def forward(self, params, x):
        with _reparametrize_module(self.model, params, tie_weights=True):
            return self.fn(x)


class ExportedInferencer(Inferencer):
    """Serve a bundle written by ``Inferencer.export_programs`` with no
    model class and no tracing: every program is a loaded ``torch.export``
    program. The padding and bucketing front-end is ``Inferencer``'s."""

    def __init__(self, bundle_dir, params: dict, manifest: dict, device: torch.device):
        self.model = None
        self.bundle_dir = Path(bundle_dir)
        self.device = device
        self._manifest = manifest
        self.latent_dim = int(manifest["latent_dim"])
        self.data_shape = tuple(manifest["data_shape"])
        io = manifest.get("io_dtype")
        self.io_dtype = None if io is None else _IO_DTYPES[io]
        self.batch_size = int(manifest["batch_size"])
        self.max_batches_per_dispatch = int(manifest["max_batches_per_dispatch"])
        self._buckets = list(manifest["buckets"])
        self._row_buckets = list(manifest.get("row_buckets", []))
        self.sub_batch_buckets = bool(self._row_buckets)
        self.params = params
        self._programs = {}  # loaded on first use; warmup() loads them all
        self._programs_lock = threading.RLock()

    @classmethod
    def load(cls, bundle_dir, device: DeviceLike = None) -> "ExportedInferencer":
        """The bundle in ``bundle_dir`` on ``device`` (default ``cuda``; the
        bundle must hold programs for its device type)."""
        # registers K1's op, which the programs call
        import hyperbolic_vae_tpu_torch.ops.gyroplane  # noqa: F401

        d = Path(bundle_dir)
        device = resolve_device(device)
        manifest = json.loads((d / "manifest.json").read_text())
        if device.type not in manifest["platforms"]:
            raise ValueError(f"the bundle holds programs for {manifest['platforms']}, "
                             f"not for {device.type}")
        params = torch.load(d / "params.pt", map_location=device, weights_only=True)
        params = {k: params[k] for k in manifest["param_paths"]}
        return cls(d, params, manifest, device)

    def supports_method(self, method: str) -> bool:
        methods = set(self._manifest["methods"])
        if method == "embed":
            # embed is host-side sugar over the encode program
            return "encode" in methods
        return method in methods

    def _program(self, key, stem: str, exported: bool, what: str):
        """The loaded program ``key`` (file ``<stem>.<device type>.pt2``),
        as a function of x alone."""
        if not exported:
            raise KeyError(f"{what} {key!r} was not exported in this bundle")

        def make():
            prog = torch.export.load(self.bundle_dir / f"{stem}.{self.device.type}.pt2").module()
            return lambda x: prog(self.params, x)

        return self._register(key, make)

    def _fn(self, method: str):
        return self._program(method, f"{method}_k1", method in self._manifest["methods"],
                             "method")

    def _fn_k(self, method: str, k: int):
        return self._program((method, k), f"{method}_k{k}", self.supports_method(method)
                             and k in self._buckets, "bucket")

    def _fn_rows(self, method: str, r: int):
        return self._program((method, "r", r), f"{method}_r{r}", self.supports_method(method)
                             and method != "generate" and r in self._row_buckets, "row bucket")
