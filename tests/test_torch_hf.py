"""The port's Hugging Face checkpoint loader (agilerl_tpu_torch.llm.hf) on the
committed fixtures tests/fixtures/hf_{llama,qwen2}_tiny (config.json,
model.safetensors and HF-generated golden logits), on the CPU: the same
checks as the JAX package's tests/test_llm/test_hf_golden.py, a sharded
checkpoint, the reader's dtypes, and, where transformers is installed, the
JAX loader's params and an in-memory HF model."""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.llm import hf as H
from agilerl_tpu_torch.llm.model import apply

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CASES = sorted(d for d in os.listdir(FIXTURES)
               if os.path.exists(os.path.join(FIXTURES, d, "golden_logits.npz")))
assert CASES, "no HF golden fixtures committed under tests/fixtures/"

_ST_NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}


def _transformers(monkeypatch):
    """transformers where it is installed, else a skip. Imported without its
    TensorFlow half (USE_TF=0): these tests load torch models only, and
    importing TensorFlow costs seconds."""
    monkeypatch.setenv("USE_TF", "0")
    return pytest.importorskip("transformers")


def _golden(name):
    path = os.path.join(FIXTURES, name)
    data = np.load(os.path.join(path, "golden_logits.npz"))
    return path, torch.as_tensor(data["token_ids"]).long(), data["logits"]


def _write_safetensors(path, tensors):
    """A minimal safetensors writer: header length, JSON header, raw bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)) + text + b"".join(blobs))


def _flat(params):
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i, blk in params["blocks"].items():
        out.update({f"{i}.{k}": v for k, v in blk.items()})
    return out


@pytest.mark.parametrize("name", CASES)
def test_load_from_disk_matches_golden_logits(name):
    path, ids, golden = _golden(name)
    config, params = H.load_hf_model(path, dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for v in _flat(params).values())
    got, _ = apply(config, params, ids)
    np.testing.assert_allclose(got.numpy(), golden, rtol=1e-4, atol=2e-4,
                               err_msg=f"{name}: port diverges from committed HF logits")


@pytest.mark.parametrize("name", CASES)
def test_bf16_load_agrees_coarsely(name):
    path, ids, golden = _golden(name)
    config, params = H.load_hf_model(path, device="cpu")  # bf16 default
    assert config.dtype == torch.bfloat16
    assert params["blocks"]["0"]["wq"].dtype == torch.bfloat16
    head = "tok_emb" if config.tie_embeddings else "lm_head"
    assert params[head].dtype == torch.float32  # the head stays f32, as the model keeps it
    got, _ = apply(dataclasses.replace(config, dtype=torch.float32), params, ids)
    scale = np.abs(golden).max()
    np.testing.assert_allclose(got.numpy() / scale, golden / scale, atol=3e-2,
                               err_msg=f"{name}: bf16-stored weights diverge")


@pytest.mark.parametrize("name", CASES)
def test_two_shard_checkpoint_loads_the_same_params(tmp_path, name):
    src, _, _ = _golden(name)
    sd = H.read_safetensors(os.path.join(src, "model.safetensors"))
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for fname, keys in shards.items():
        _write_safetensors(tmp_path / fname, {k: sd[k] for k in keys})
    index = {"metadata": {}, "weight_map": {k: f for f, ks in shards.items() for k in ks}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
    (tmp_path / "config.json").write_text(open(os.path.join(src, "config.json")).read())
    _, want = H.load_hf_model(src, dtype=torch.float32, device="cpu")
    _, got = H.load_hf_model(str(tmp_path), dtype=torch.float32, device="cpu")
    want, got = _flat(want), _flat(got)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reader_takes_f32_f16_bf16(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {f"w_{n}": torch.randn(3, 5, generator=g).to(dt) for dt, n in _ST_NAMES.items()}
    tensors["empty"] = torch.zeros(0, 4)
    _write_safetensors(tmp_path / "x.safetensors", tensors)
    got = H.read_safetensors(str(tmp_path / "x.safetensors"))
    assert list(got) == list(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


@pytest.mark.parametrize("name", CASES)
def test_config_from_hf_dict_and_object(name, monkeypatch):
    path, _, _ = _golden(name)
    with open(os.path.join(path, "config.json")) as fh:
        raw = json.load(fh)
    cfg = H.config_from_hf(raw)
    assert (cfg.vocab_size, cfg.n_layer, cfg.d_model) == (256, 2, 64)
    assert cfg.qkv_bias == (raw["model_type"] == "qwen2")
    assert cfg.tie_embeddings == raw["tie_word_embeddings"]
    transformers = _transformers(monkeypatch)
    assert H.config_from_hf(transformers.AutoConfig.from_pretrained(path)) == cfg


def test_rotate_half_permutation_matches_jax():
    jhf = pytest.importorskip("agilerl_tpu.llm.hf")
    w = np.arange(3 * 32, dtype=np.float32).reshape(3, 32)
    want = jhf._rotate_half_to_interleaved(w, 2, 16)
    np.testing.assert_array_equal(H._rotate_half_to_interleaved(w, 2, 16), want)
    np.testing.assert_array_equal(H._rotate_half_to_interleaved(torch.as_tensor(w), 2, 16).numpy(),
                                  want)


@pytest.mark.parametrize("name", CASES)
def test_params_match_the_jax_loader(name, monkeypatch):
    """Where transformers is installed: the JAX package's load_hf_model (HF
    AutoModel) gives the same f32 params, key for key."""
    _transformers(monkeypatch)
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from agilerl_tpu.llm.hf import load_hf_model as j_load

    path, _, _ = _golden(name)
    _, jparams = j_load(path, dtype=jnp.float32)
    _, tparams = H.load_hf_model(path, dtype=torch.float32, device="cpu")
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    tflat = _flat(tparams)
    assert sorted(tflat) == sorted(jflat)
    for k, w in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_convert_and_verify_an_in_memory_hf_model(name, monkeypatch):
    transformers = _transformers(monkeypatch)
    path, _, _ = _golden(name)
    model = transformers.AutoModelForCausalLM.from_pretrained(path, dtype=torch.float32)
    config, params = H.convert_hf_model(model, device="cpu")
    _, loaded = H.load_hf_model(path, dtype=torch.float32, device="cpu")
    for k, w in _flat(loaded).items():
        assert torch.equal(_flat(params)[k], w), k
    assert H.verify_against_hf(model, config, params) < 2e-4


def test_transformers_entry_points_raise_a_clear_import_error(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    for call in (lambda: H.load_hf_tokenizer("x"), lambda: H.convert_hf_model(object()),
                 lambda: H.verify_against_hf(None, None, None)):
        with pytest.raises(ImportError, match="transformers package is not installed"):
            call()
