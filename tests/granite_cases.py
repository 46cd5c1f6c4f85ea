"""The Granite configuration file at test size, for the CPU tests: every
kind of the published layer pattern (Mamba, attention, Mamba), the shared
expert, NoPE and the four multipliers kept; widths, depth, vocabulary and
experts cut (16 routed, top 4, 2 held: eight shares)."""
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "ncbench" / "configs" / "granite-4.0-h-small-ep8.json"
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=1,
            mamba_d_head=16, mamba_n_heads=8, mamba_d_state=16,
            mamba_chunk_size=8, vocab_size=256, intermediate_size=32,
            shared_intermediate_size=48, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"],
            experts_published=16, num_local_experts=2,
            num_experts_per_tok=4, dtype="float32")
TRAFFIC = dict(batch=3, prompt_median=20, prompt_sigma=0.5, prompt_min=5,
               prompt_max=40, continuation=8)
STEPS = [0, 4, 8]


def tiny_config(**overrides) -> dict:
    """The configuration file's dict at test size (float32 program)."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(TINY)
    cfg["check"] = dict(cfg["check"], steps=list(STEPS))
    cfg.update(overrides)
    return cfg
