"""Long-prompt embedding: 77-token windows, all through CLIP in one batch.

Counterpart of ``editanything_tpu/engine/prompts.py``: both prompts are
tokenized without truncation, padded to a shared number of 77-token windows
with EOS, and every window of both rides the batch axis of one encoder call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from editanything_tpu_torch.utils import trace


def window_ids(tokenizer, prompt: str, negative_prompt: str = "",
               max_windows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize both prompts to (W, context_length) int32 grids (shared W)."""
    ctx = tokenizer.context_length
    p = [tokenizer.bos_id] + tokenizer.encode(prompt) + [tokenizer.eos_id]
    n = [tokenizer.bos_id] + tokenizer.encode(negative_prompt) + [tokenizer.eos_id]
    w = max(1, -(-max(len(p), len(n)) // ctx))
    if max_windows is not None:
        w = min(w, max_windows)
    total = w * ctx

    def grid(ids):
        arr = np.full((total,), tokenizer.eos_id, np.int32)
        arr[:min(len(ids), total)] = ids[:total]
        return arr.reshape(w, ctx)

    return grid(p), grid(n)


def encode_windows(text_model, ids, *, layer_skip: Optional[int] = None
                   ) -> torch.Tensor:
    """(W, 77) window ids -> the (1, W*77, D) context of one encoder call
    over the windows."""
    hidden = text_model(ids, layer_skip=layer_skip)
    w, n, d = hidden.shape
    return hidden.reshape(1, w * n, d)


def get_pipeline_embeds(text_model, tokenizer, prompt: str,
                        negative_prompt: str = "", *,
                        layer_skip: Optional[int] = None,
                        max_windows: Optional[int] = None):
    """prompt/negative -> (cond, uncond) context, each (1, W*77, D), from
    one encoder call over the (2W, 77) window batch."""
    pids, nids = window_ids(tokenizer, prompt, negative_prompt,
                            max_windows=max_windows)
    w = pids.shape[0]
    device = text_model.embeddings.token_embedding.weight.device
    trace.count("sync.text.ids")
    ids = torch.from_numpy(np.concatenate([pids, nids])).to(device, torch.long)
    hidden = text_model(ids, layer_skip=layer_skip)
    d = hidden.shape[-1]
    return hidden[:w].reshape(1, -1, d), hidden[w:].reshape(1, -1, d)
