"""A small configuration and mix of the serving cells' shape, for CPU
tests of the harness (not a benchmark configuration)."""

SMALL_HF = dict(
    model_type="llava_phi", vocab_size=512, hidden_size=256,
    intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, rms_norm_eps=1e-5, max_position_embeddings=4096,
    original_max_position_embeddings=4096, mm_hidden_size=128,
    mm_projector_type="moe", moe_name="competesmoe", num_experts=4,
    num_selected=2, clip_smoe=True, mlp_smoe=True, scales=[1],
    vision_config=dict(hidden_size=128, intermediate_size=256,
                       num_hidden_layers=3, num_attention_heads=2,
                       image_size=28, patch_size=14),
    tokenizer_model_max_length=2048)

CFG = dict(name="small", runner="serve", hf_config=SMALL_HF,
           deployment=dict(load_4bit=True, kv_quant="int8", engine_slots=4,
                           engine_max_len=128, speculative=0,
                           engine_pipeline=2),
           check=dict(widest_gap=0.02, worst_image_median_err=0.02))

MIX = dict(kind="closed_loop", clients=4, pool=32, layout_seed=5,
           prompt_tokens=dict(dist="uniform", min=8, max=40),
           image_share=0.25, image_size=28, image_at=1,
           output_tokens=dict(dist="uniform", min=4, max=12),
           sampled_share=0.125, temperature=0.7, top_p=0.9,
           stagger_s=0.05, ramp_s=1.0, check_tokens=40)

CELL = {"name": "small", "config": "small", "traffic": "small", "chips": 1}
