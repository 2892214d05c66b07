"""POCO: the implicit occupancy network (twin of models/occupancy).

Reference: models/POCO (FKAConv backbone + InterpAttentionKHeadsNet
decoder, generate_1.py facade, train.py training loop).
"""
from __future__ import annotations

import pickle

from ...pipeline.pipeline import resolve_device
from .convert import init_params, load_torch_checkpoint
from .network import (Network, encode_latents, make_poco_field,
                      network_from_tree, query_occupancy)
from .spatial import compute_spatial, farthest_point_sampling
from .train import load_checkpoint


def load_poco_field(checkpoint_path: str, logger=None,
                    decoder: str = "InterpAttentionKHeadsNet",
                    device="cuda"):
    """A factory points -> field for pipeline.geometry, the network on
    `device` (reference create_POCO_network, generate_1.py:54-68;
    `decoder` is the network_decoder config key, generate.py:305).

    Reads a checkpoint written by either package's `train.save_checkpoint`
    (a pickle with a 'params' tree; a JAX one without importing optax), or
    else a reference torch checkpoint (checkpoint.pth, through
    `convert.load_torch_checkpoint`)."""
    dev = resolve_device(device)
    if logger:
        logger.info(f"Loading POCO checkpoint {checkpoint_path} "
                    f"(decoder={decoder})")
    try:
        blob = load_checkpoint(checkpoint_path)
        if not (isinstance(blob, dict) and "params" in blob):
            raise ValueError("not a native checkpoint")
        params = blob["params"]
    except (pickle.UnpicklingError, ValueError, EOFError) as e:
        # only not-a-native-pickle errors go to the torch converter: a
        # corrupt native checkpoint must not surface as an unrelated
        # torch-conversion failure
        if logger:
            logger.info(f"not a native checkpoint ({e!r}); trying the "
                        "torch converter")
        params = load_torch_checkpoint(checkpoint_path)
    network = network_from_tree(params, decoder, dev)

    def factory(points, **field_kwargs):
        # field_kwargs go to make_poco_field (e.g. noise_std=0.0 for inputs
        # that already carry sensor noise, generate_1.py:71-72)
        return make_poco_field(network, points, **field_kwargs)

    return factory


__all__ = ["Network", "compute_spatial", "encode_latents",
           "farthest_point_sampling", "init_params", "load_poco_field",
           "load_torch_checkpoint", "make_poco_field", "network_from_tree",
           "query_occupancy"]
