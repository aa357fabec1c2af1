"""Decode-length predictor (§5.3.3), torch port of
``repro/core/predictor.py``.

A small classifier buckets a prompt's expected decode length (buckets of
128 tokens). The paper trains OPT-125M on (prompt -> observed decode
length); this is an MLP over bag-of-token features, trained on a
synthetic corpus whose decode lengths follow prompt statistics (code
prompts decode long, short chat short). The JE runs it on the host, per
placement, so it lives on the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass
class PredictorConfig:
    bucket_size: int = 128
    n_buckets: int = 8
    n_features: int = 64
    hidden: int = 128
    lr: float = 3e-3
    steps: int = 300
    batch: int = 256


def featurize(prompt_tokens: np.ndarray, n_features: int) -> np.ndarray:
    """Cheap prompt features: length stats + hashed bag-of-tokens."""
    f = np.zeros((n_features,), np.float32)
    n = len(prompt_tokens)
    f[0] = math.log1p(n) / 10.0
    f[1] = (n % 97) / 97.0
    if n:
        f[2] = float(np.mean(prompt_tokens)) / 260.0
        f[3] = float(np.std(prompt_tokens)) / 130.0
        idx = (prompt_tokens * 2654435761 % (n_features - 4)).astype(np.int64)
        np.add.at(f, 4 + idx, 1.0 / max(n, 1))
    return f


def synth_trace(n: int, cfg: PredictorConfig, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Synthetic (prompt, decode-length) pairs with learnable structure:
    three latent request classes (chat / code / summarize) with different
    token distributions and decode-length regimes + noise."""
    rng = np.random.RandomState(seed)
    xs, ys, prompts = [], [], []
    for _ in range(n):
        cls = rng.randint(3)
        if cls == 0:    # chat: short prompt, short decode
            plen = rng.randint(8, 64)
            toks = rng.randint(3, 120, plen)
            dlen = 40 + plen + int(rng.randn() * 14)
        elif cls == 1:  # code: marker tokens, long decode
            plen = rng.randint(32, 256)
            toks = np.concatenate([rng.randint(120, 200, plen - 4), [123, 125, 40, 41]])
            dlen = 520 + plen // 2 + int(rng.randn() * 36)
        else:           # summarize: long prompt, medium decode
            plen = rng.randint(256, 512)
            toks = rng.randint(3, 255, plen)
            dlen = 140 + plen // 4 + int(rng.randn() * 24)
        dlen = int(np.clip(dlen, 1, cfg.bucket_size * cfg.n_buckets - 1))
        xs.append(featurize(toks, cfg.n_features))
        ys.append(dlen // cfg.bucket_size)
        prompts.append(toks)
    return np.stack(xs), np.asarray(ys, np.int32), prompts


def init_predictor(cfg: PredictorConfig, gen: torch.Generator) -> dict:
    """Scaled normal weights drawn from ``gen``, zero biases (fp32)."""
    return {
        "w1": torch.randn((cfg.n_features, cfg.hidden), generator=gen)
        * (1 / math.sqrt(cfg.n_features)),
        "b1": torch.zeros((cfg.hidden,)),
        "w2": torch.randn((cfg.hidden, cfg.n_buckets), generator=gen)
        * (1 / math.sqrt(cfg.hidden)),
        "b2": torch.zeros((cfg.n_buckets,)),
    }


def predictor_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def train_predictor(cfg: PredictorConfig, xs: np.ndarray, ys: np.ndarray,
                    seed: int = 0) -> Tuple[dict, float]:
    """Adam-trained classifier (beta 0.9 / 0.999, bias correction, eps
    1e-8) on the first 80% of the trace, minibatches drawn by
    ``np.random.RandomState(seed)``; returns (params, held-out
    accuracy)."""
    n = len(xs)
    n_tr = int(n * 0.8)
    xtr, ytr = torch.from_numpy(xs[:n_tr]), torch.from_numpy(ys[:n_tr]).long()
    xte, yte = torch.from_numpy(xs[n_tr:]), torch.from_numpy(ys[n_tr:]).long()
    params = init_predictor(cfg, torch.Generator().manual_seed(seed))
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    rng = np.random.RandomState(seed)
    for t in range(1, cfg.steps + 1):
        idx = torch.from_numpy(rng.randint(0, n_tr, cfg.batch))
        p = {k: a.detach().requires_grad_() for k, a in params.items()}
        lg = predictor_logits(p, xtr[idx])
        loss = -torch.log_softmax(lg, -1).gather(1, ytr[idx][:, None]).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, a), g in zip(params.items(), grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mh = m[k] / (1 - 0.9 ** t)
                vh = v[k] / (1 - 0.999 ** t)
                params[k] = a - cfg.lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        acc = float((predictor_logits(params, xte).argmax(-1) == yte)
                    .float().mean())
    return params, acc


class TraceEMAPredictor:
    """Online decode-length estimator fed by completed requests.

    Requests bucket into a mix by log2 prompt length, and each bucket
    keeps an exponential moving average of observed decode lengths:
    ``observe`` per completion, ``predict_tokens`` per placement (the
    interface ``DistributedScheduler.pd_aware`` reads)."""

    def __init__(self, alpha: float = 0.25, default_guess: int = 64,
                 n_bins: int = 12):
        self.alpha = alpha
        self.default_guess = default_guess
        self.n_bins = n_bins
        self._ema: dict = {}            # bin -> EMA decode length
        self._count: dict = {}          # bin -> observations

    def _bin(self, prompt_tokens) -> int:
        n = max(1, len(prompt_tokens))
        return min(self.n_bins - 1, int(math.log2(n)))

    def observe(self, prompt_tokens, decode_len: int) -> None:
        b = self._bin(prompt_tokens)
        cur = self._ema.get(b)
        self._ema[b] = (float(decode_len) if cur is None
                        else (1.0 - self.alpha) * cur
                        + self.alpha * float(decode_len))
        self._count[b] = self._count.get(b, 0) + 1

    def predict_tokens(self, prompt_tokens) -> int:
        b = self._bin(prompt_tokens)
        if b in self._ema:
            return max(1, int(round(self._ema[b])))
        if self._ema:               # nearest trained mix beats the default
            nearest = min(self._ema, key=lambda k: abs(k - b))
            return max(1, int(round(self._ema[nearest])))
        return self.default_guess

    def n_observations(self) -> int:
        return sum(self._count.values())


class DecodeLengthPredictor:
    """Inference side of the predictor, read by PD-aware scheduling."""

    def __init__(self, cfg: PredictorConfig, params: dict):
        self.cfg = cfg
        self.params = params

    @torch.no_grad()
    def predict_bucket(self, prompt_tokens) -> int:
        x = torch.from_numpy(featurize(np.asarray(prompt_tokens),
                                       self.cfg.n_features))[None]
        return int(predictor_logits(self.params, x).argmax(-1)[0])

    def predict_tokens(self, prompt_tokens) -> int:
        b = self.predict_bucket(prompt_tokens)
        return b * self.cfg.bucket_size + self.cfg.bucket_size // 2
