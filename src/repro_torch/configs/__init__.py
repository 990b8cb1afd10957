"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

Each module defines ``config() -> ModelConfig`` with the exact assigned
hyper-parameters, citing its source paper / model card.

A copy of ``repro/configs`` (the port imports nothing of ``repro``);
``tests/test_torch_transformer.py`` holds every arch's config, and its
``reduced()`` variant, equal to the reference's.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig, SSMConfig, reduced

ARCHS = (
    "jamba_v0_1_52b",
    "seamless_m4t_medium",
    "deepseek_v3_671b",
    "xlstm_350m",
    "deepseek_v2_lite_16b",
    "qwen2_vl_7b",
    "qwen2_72b",
    "gemma_2b",
    "minitron_8b",
    "gemma_7b",
)

# Public ids (as assigned) -> module names
ARCH_IDS = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-350m": "xlstm_350m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen2-72b": "qwen2_72b",
    "gemma-2b": "gemma_2b",
    "minitron-8b": "minitron_8b",
    "gemma-7b": "gemma_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    mod_name = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()
