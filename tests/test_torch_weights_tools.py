"""`convert --plan` (`weights/manifest.py`) and `convert --verify`
(`weights/verify.py`) of the PyTorch port against the JAX package's.

The manifest's tables equal JAX's and the plan covers the port's convert
registry exactly, naming the port's command and `.safetensors` outputs.
The JAX plan fetches a hub repo once with its first `--include` filter only
(`anyedit_tpu/weights/manifest.py:180`), so the second slot's files of a
shared repo never arrive; the port's fetch carries every filter. The
verifier tables equal JAX's; with `transformers`, tiny random HF
checkpoints saved with `save_pretrained` stand in for the downloads: the
port's plan gives parity within the family's tolerance, a q / k swap in the
plan is caught and nothing is written, and the refusals hold.
"""

import dataclasses
import shlex
import sys

import pytest
import torch

from anyedit_tpu.weights import manifest as jman
from anyedit_tpu.weights import verify as jver
from anyedit_tpu_torch.cli import main as cli_main
from anyedit_tpu_torch.weights import bootstrap
from anyedit_tpu_torch.weights import manifest as tman
from anyedit_tpu_torch.weights import verify as tver


def test_manifest_and_assets_equal_jax():
    for jt, tt in ((jman.MANIFEST, tman.MANIFEST), (jman.ASSETS, tman.ASSETS)):
        assert list(tt) == list(jt)
        for k in jt:
            assert dataclasses.asdict(tt[k]) == dataclasses.asdict(jt[k]), k


def _plan(capsys) -> list[str]:
    assert cli_main(["convert", "--plan", "dl", "--weights-dir", "w"]) == 0
    return capsys.readouterr().out.splitlines()


def test_plan_covers_the_port_registry(capsys):
    plan = _plan(capsys)
    assert plan[0] == "#!/bin/sh"
    converts = [line for line in plan if "convert --model" in line]
    assert all(line.startswith("python -m anyedit_tpu_torch convert ") for line in converts)
    assert len(converts) == len(bootstrap.REGISTRY) == 33
    for name in bootstrap.REGISTRY:
        line = [x for x in converts if f"--model {name} " in x]
        assert len(line) == 1, name
        assert f"--out {shlex.quote(f'w/{name}.safetensors')}" in line[0], name
        assert (" --verify" in line[0]) == (name in tver.VERIFIERS), name
    fetches = [x for x in plan if x.startswith(("huggingface-cli", "wget"))]
    assert len(fetches) == len(set(fetches))
    assert len([x for x in fetches if "8687" in x]) == 1     # one AnyDoor ckpt, four slots
    for x in fetches:
        assert ("$HF_TOKEN" in x) == ("meta-llama" in x), x
    for asset in tman.ASSETS:
        assert any(x.startswith("cp ") and x.endswith(f"w/{asset}") for x in plan), asset


def _hub_lines(plan) -> dict[str, str]:
    return {x.split()[2]: x for x in plan if x.startswith("huggingface-cli download")}


def test_shared_repo_fetch_keeps_every_filter(capsys):
    """Each hub repo is fetched once, with every entry's `--include`
    (none when an entry takes the whole repo). The JAX plan's SD1.5 fetch
    carries only `unet/*`: the VAE's files are never downloaded."""
    lines = _hub_lines(_plan(capsys))
    entries = {}
    for s in list(tman.MANIFEST.values()) + list(tman.ASSETS.values()):
        if s.hub:
            entries.setdefault(s.hub, []).append(s.include)
    assert set(lines) == set(entries)
    for hub, includes in entries.items():
        line = lines[hub]
        if None in includes:
            assert "--include" not in line, hub
        else:
            assert all(shlex.quote(i) in line for i in includes), hub
    assert "'vae/*'" in lines["runwayml/stable-diffusion-v1-5"]
    assert "'text_encoder_2/*'" in lines["stabilityai/stable-diffusion-xl-base-1.0"]
    jax_lines = _hub_lines(jman.emit_plan("dl", "w").splitlines())
    assert "'unet/*'" in jax_lines["runwayml/stable-diffusion-v1-5"]
    assert "'vae/*'" not in jax_lines["runwayml/stable-diffusion-v1-5"]
    assert "text_encoder_2" not in jax_lines["stabilityai/stable-diffusion-xl-base-1.0"]


def test_verifier_tables_equal_jax():
    assert list(tver.VERIFIERS) == list(jver.VERIFIERS)
    assert tver.TOLERANCE == jver.TOLERANCE and tver.DEFAULT_TOL == jver.DEFAULT_TOL


def test_verify_without_transformers_names_it(tmp_path, monkeypatch):
    """Where `transformers` is missing (the GPU machine), `--verify` raises
    an ImportError naming it; it is never skipped."""
    (tmp_path / "config.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        cli_main(["convert", "--model", "clip_text", "--src", str(tmp_path), "--out",
                  str(tmp_path / "x.safetensors"), "--verify"])
    assert not (tmp_path / "x.safetensors").exists()


# ---- with transformers: tiny HF checkpoints ------------------------------------

def _save(tmp_path, model, name):
    d = tmp_path / name
    model.eval().save_pretrained(d)
    return d


@pytest.fixture
def clip_text_dir(tmp_path):
    tf = pytest.importorskip("transformers")
    cfg = tf.CLIPTextConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=128,
                            max_position_embeddings=16, hidden_act="quick_gelu",
                            attention_dropout=0.0, eos_token_id=126, bos_token_id=125)
    torch.manual_seed(0)
    return _save(tmp_path, tf.CLIPTextModel(cfg), "clip_text_ckpt")


def test_verify_clip_text_parity(clip_text_dir):
    assert tver.verify_conversion("clip_text", clip_text_dir) < tver.DEFAULT_TOL


def test_verify_catches_a_swapped_plan(clip_text_dir, tmp_path, monkeypatch):
    """q and k read from each other's tensors (same shapes, so the strict
    load passes): `convert --verify` raises and writes no file."""
    entry = bootstrap.REGISTRY["clip_text"]

    def swapped(keys, src_keys, module=None):
        plan = entry.plan(keys, src_keys, module)
        swap = {".q_proj.": ".k_proj.", ".k_proj.": ".q_proj."}
        out = {}
        for k, (kind, names) in plan.items():
            for a, b in swap.items():
                if a in k:
                    names = tuple(n.replace(a, b) for n in names)
                    break
            out[k] = (kind, names)
        return out

    monkeypatch.setitem(bootstrap.REGISTRY, "clip_text",
                        dataclasses.replace(entry, plan=swapped))
    out = tmp_path / "clip_text.safetensors"
    with pytest.raises(AssertionError, match="parity FAILED"):
        cli_main(["convert", "--model", "clip_text", "--src", str(clip_text_dir), "--out",
                  str(out), "--verify"])
    assert not out.exists()


def _tiny_clip_vision(tf):
    return tf.CLIPVisionModelWithProjection(tf.CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, projection_dim=16,
        hidden_act="quick_gelu"))


def _tiny_t5(tf):
    return tf.T5EncoderModel(tf.T5Config(
        vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", dropout_rate=0.0))


def _tiny_dinov2(tf):
    return tf.Dinov2Model(tf.Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        image_size=28, patch_size=7, layerscale_value=0.5))


def _tiny_depth(tf):
    bb = tf.Dinov2Config(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
                         intermediate_size=128, image_size=56, patch_size=14,
                         layerscale_value=1e-5, hidden_act="gelu",
                         attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
                         drop_path_rate=0.0, out_indices=[1, 2, 3, 4], apply_layernorm=True,
                         reshape_hidden_states=False)
    return tf.DepthAnythingForDepthEstimation(tf.DepthAnythingConfig(
        backbone_config=bb, fusion_hidden_size=16, reassemble_hidden_size=32,
        neck_hidden_sizes=[8, 8, 16, 16], reassemble_factors=[4, 2, 1, 0.5], patch_size=14,
        head_hidden_size=32, head_in_index=-1))


def _tiny_sam(tf):
    """The port's SAM fixes the MLP ratios (4x in the encoder, 8x in the
    decoder) and the Fourier width (out_dim / 2), as the JAX one does."""
    vc = tf.SamVisionConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                            image_size=64, patch_size=8, window_size=4, global_attn_indexes=[1],
                            output_channels=32, mlp_dim=128, num_pos_feats=16)
    pc = tf.SamPromptEncoderConfig(hidden_size=32, image_size=64, patch_size=8,
                                   mask_input_channels=4)
    mc = tf.SamMaskDecoderConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                 mlp_dim=256, iou_head_hidden_dim=32)
    return tf.SamModel(tf.SamConfig(vision_config=vc.to_dict(), prompt_encoder_config=pc.to_dict(),
                                    mask_decoder_config=mc.to_dict()))


def _tiny_gdino(tf):
    """`tests/test_golden_hf.py::test_gdino_matches_hf`'s configuration."""
    sw = tf.SwinConfig(image_size=64, patch_size=4, embed_dim=16, depths=[1, 1], num_heads=[2, 2],
                       window_size=4, out_features=["stage1", "stage2"])
    bt = tf.BertConfig(vocab_size=1100, hidden_size=32, num_hidden_layers=1,
                       num_attention_heads=2, intermediate_size=128, max_position_embeddings=32,
                       type_vocab_size=2)
    return tf.GroundingDinoForObjectDetection(tf.GroundingDinoConfig(
        backbone_config=sw, text_config=bt, d_model=32, encoder_layers=1, decoder_layers=1,
        num_queries=12, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=2, encoder_n_points=2,
        decoder_n_points=2, max_text_len=16))


def _tiny_gdino_extra_level(tf):
    """Three Swin stages and four feature levels, so that one level is the
    stride-2 3x3 conv of the last backbone map; the verifier's probe (16 x
    patch = 64 px) gives that map 4x4, an even side, where Flax "SAME" would
    pad (0, 1) and the official model pads (1, 1)."""
    sw = tf.SwinConfig(image_size=64, patch_size=4, embed_dim=16, depths=[1, 1, 1],
                       num_heads=[2, 2, 2], window_size=4,
                       out_features=["stage1", "stage2", "stage3"])
    bt = tf.BertConfig(vocab_size=1100, hidden_size=32, num_hidden_layers=1,
                       num_attention_heads=2, intermediate_size=128, max_position_embeddings=32,
                       type_vocab_size=2)
    return tf.GroundingDinoForObjectDetection(tf.GroundingDinoConfig(
        backbone_config=sw, text_config=bt, d_model=32, encoder_layers=1, decoder_layers=1,
        num_queries=12, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=4, encoder_n_points=2,
        decoder_n_points=2, max_text_len=16))


@pytest.mark.parametrize("name,build", [("clip_vision", _tiny_clip_vision), ("t5", _tiny_t5),
                                        ("dinov2", _tiny_dinov2), ("depth", _tiny_depth),
                                        ("sam", _tiny_sam), ("gdino", _tiny_gdino),
                                        ("gdino", _tiny_gdino_extra_level)])
def test_verify_family_parity(tmp_path, name, build):
    """Each family's config derived from config.json and its plan (the HF
    layouts of Depth-Anything, DINOv2, SAM and GroundingDINO, T5's shared
    embedding) within the JAX tolerance. SAM's checkpoint as
    `save_pretrained` writes it holds the tied Fourier matrix once, as
    `shared_image_embedding.positional_embedding`. GroundingDINO also at 3
    stages and 4 levels with an even last map (the extra level's padding)."""
    tf = pytest.importorskip("transformers")
    torch.manual_seed(1)
    d = _save(tmp_path, build(tf), f"{name}_ckpt")
    assert tver.verify_conversion(name, d) <= tver.TOLERANCE.get(name, tver.DEFAULT_TOL)


def test_verify_refusals(tmp_path):
    pytest.importorskip("transformers")
    with pytest.raises(ValueError, match="not supported"):
        tver.verify_conversion("lama", tmp_path)
    with pytest.raises(ValueError, match="HF model directory"):
        tver.verify_conversion("clip_text", tmp_path / "nope.pth")
