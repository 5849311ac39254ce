"""Chunked "anytime" split of the test-mode forward for serving:
counterpart of `raft_stereo_tpu/models/anytime.py`.

    prelude   images -> refinement state         (encoders, corr state)
    chunk     state  -> state, `chunk_iters` GRU iterations further
    finalize  state  -> (flow_lowres, flow_up)   (mask head + upsample)

All three run on one `RAFTStereo` module's parameters, through the same
methods its `forward` uses, so prelude + k chunks + finalize equals
`model(i1, i2, iters=k * chunk_iters)` exactly. The state is the dict
{"net", "coords1", "context", "corr", "coords0"}.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo


def prelude(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor,
            flow_init: Optional[torch.Tensor] = None) -> dict:
    return model.apply_flow_init(model.encode_features(image1, image2), flow_init)


def chunk(model: RAFTStereo, state: dict, chunk_iters: int) -> dict:
    for _ in range(chunk_iters):
        state = model.iteration_step(state)
    return state


def finalize(model: RAFTStereo, state: dict):
    return model.finalize(state)
