"""The benchmark's weights: made on the device from the seed, in the type
they are served in, a few large calls, in the tree layout the program
takes (``Engine(params=...)``): stacked ``(L, in, out)`` projections,
``(V, D)`` embedding and head, unit norms. The same seed on the same device
gives the same tree, so the reference makes it again after the program's
run instead of keeping it.
"""

from __future__ import annotations

import torch

STD = 0.02


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """N(0, 0.02) projections, biases (where the model has them), embedding
    and head (``model["init_std"]`` in place of 0.02 where given); ones for
    the norms (and qwen3's q/k norms)."""
    g = seed_generator(seed, device)
    D, I = model["hidden_size"], model["intermediate_size"]
    L, V = model["num_hidden_layers"], model["vocab_size"]
    H, Hkv, Dh = model["num_attention_heads"], model["num_key_value_heads"], model["head_dim"]

    std = model.get("init_std", STD)

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    layers = {"wq": nrm(L, D, H * Dh), "wk": nrm(L, D, Hkv * Dh), "wv": nrm(L, D, Hkv * Dh),
              "wo": nrm(L, H * Dh, D), "w_gate": nrm(L, D, I), "w_up": nrm(L, D, I),
              "w_down": nrm(L, I, D), "ln_attn": ones(L, D), "ln_mlp": ones(L, D)}
    if model.get("attention_bias"):
        layers.update(bq=nrm(L, H * Dh), bk=nrm(L, Hkv * Dh), bv=nrm(L, Hkv * Dh))
    if model.get("qk_norm"):
        layers.update(q_norm=ones(L, Dh), k_norm=ones(L, Dh))
    tree = {"embed": nrm(V, D), "layers": layers, "final_norm": ones(D)}
    if not model.get("tie_word_embeddings"):
        tree["lm_head"] = nrm(V, D)
    return tree
