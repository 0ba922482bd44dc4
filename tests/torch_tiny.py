"""The tiny VLA of the port's tests, in either package's config classes.

Imports neither package, so the card tests (which run where JAX is not
installed) share it with the CPU parity tests.
"""


def tiny_cfg(C, K):
    """The same tiny VLA in either package's config classes."""
    return C.VLAConfig(
        platform="libero",
        custom_constants=K.PlatformConstants(
            name="test", num_actions_chunk=8, action_dim=7, proprio_dim=8,
            normalization_type=K.NormalizationType.BOUNDS_Q99,
            num_action_query_tokens=16),
        vision=C.FusedVisionConfig(
            primary=C.ViTConfig(
                name="dino-tiny", image_size=28, patch_size=14,
                hidden_size=32, num_layers=3, num_heads=4, mlp_dim=64,
                use_cls_token=True, num_register_tokens=2,
                pos_embed_patches_only=True, layer_scale_init=1e-5,
                mlp_activation="gelu"),
            fused=C.ViTConfig(
                name="siglip-tiny", image_size=28, patch_size=14,
                hidden_size=48, num_layers=3, num_heads=2, mlp_dim=40,
                use_cls_token=False, num_register_tokens=0,
                pos_embed_patches_only=False, layer_scale_init=None,
                mlp_activation="gelu_tanh"),
            num_images=2),
        llm=C.Qwen2Config(vocab_size=512, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_size=128,
                          head_dim=16),
        head=C.ActionHeadConfig(num_blocks=2, hidden_dim=64,
                                num_attn_heads=4, use_pro_version=True),
        max_text_tokens=96,
    )
