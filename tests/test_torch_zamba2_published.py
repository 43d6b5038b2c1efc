"""``zamba2-1.2b-published``: the port's published Zamba2 layout on the CPU
at its smoke size, in float32, on seeded random weights.

* Against the plain reference ``perfbench/reference/hybrid_lm.py``: a
  prefill, then one decode step a token through the cache, against the
  reference's full forward, by logits, for both values of each adapter flag.
* Against transformers' ``Zamba2ForCausalLM`` with the same weights mapped
  in (where transformers is installed): the layer equations are the
  published ones.
* ``zamba2-1.2b`` (the layout the JAX package runs) gives the logits it
  gave before the zamba2 layout existed.
* The parameter tree, the count, the invocation counter, and the paths
  the layout refuses.

Imports no jax."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import shared_layers, zamba2_layout
from repro_torch.models import decode_step, forward_train, init_cache, init_params, prefill

NAME = "zamba2-1.2b-published"
REF = Path(__file__).resolve().parents[1] / "perfbench" / "reference" / "hybrid_lm.py"
# (use_shared_mlp_adapter, use_shared_attention_adapter)
FLAGS = [(mlp, att) for mlp in (True, False) for att in (True, False)]

# float32 on both sides.  The port scans in chunks of 8 at this size, the
# reference in one chunk of 256, transformers in one chunk; attention and
# the products sum in other orders: they agree to ~2e-6 of the largest
# logit.  A bf16 model reads ~1e-2 here.
TOL = 2e-5


def _reference():
    spec = importlib.util.spec_from_file_location("perfbench.reference.hybrid_lm", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arch(mlp=True, att=True):
    return get_smoke_config(NAME).variant(dtype="float32", use_shared_mlp_adapter=mlp, use_shared_attention_adapter=att)


def _served(params, arch, prompt, served):
    """The port's logits at the positions that chose each served token:
    prefill of the prompt, then one decode step a served token."""
    cache = init_cache(arch, 1, 64, "cpu")
    with torch.inference_mode():
        logits, cache = prefill(params, arch, {"tokens": torch.tensor([prompt])}, cache)
        out = [logits[0, -1]]
        for i, tok in enumerate(served[:-1]):
            logits, cache = decode_step(params, arch, torch.tensor([[tok]]),
                                        torch.tensor([len(prompt) + i], dtype=torch.int32), cache)
            out.append(logits[0, 0])
    return torch.stack(out)


def _requests(seed=5):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, 256, (plen,), generator=g).tolist(), torch.randint(0, 256, (n,), generator=g).tolist())
            for plen, n in ((13, 9), (29, 4), (3, 20))]


def _shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{pre}{k}."))
        else:
            out[pre + k] = (tuple(v[0]) if isinstance(v, tuple) else tuple(v.shape))
    return out


@pytest.mark.parametrize("mlp,att", FLAGS)
def test_port_matches_the_plain_reference(mlp, att):
    arch = _arch(mlp, att)
    params = init_params(torch.Generator().manual_seed(0), arch)
    ref = _reference()
    cfg = dataclasses.asdict(arch)
    assert _shapes(ref.layout(cfg)) == _shapes(params)
    reqs = _requests()
    for (prompt, served), r in zip(reqs, ref.served_logits(params, cfg, reqs)):
        p = _served(params, arch, prompt, served)
        assert r.shape == p.shape == (len(served), arch.vocab_size)
        assert (r - p).abs().max() <= TOL * r.abs().max()


def _hf_model(params, arch):
    """transformers' Zamba2ForCausalLM of ``arch`` holding ``params``."""
    tf = pytest.importorskip("transformers")
    L, a, f, r = arch.n_layers, 2 * arch.d_model, arch.d_ff, arch.adapter_rank
    hc = tf.Zamba2Config(
        vocab_size=arch.vocab_size, hidden_size=arch.d_model, num_hidden_layers=L,
        layers_block_type=["hybrid" if i in arch.hybrid_layer_ids else "mamba" for i in range(L)],
        mamba_d_state=arch.ssm_state, mamba_d_conv=arch.ssm_conv, mamba_expand=arch.ssm_expand,
        mamba_ngroups=arch.ssm_groups, n_mamba_heads=arch.ssm_expand * arch.d_model // arch.ssm_head_dim,
        # one chunk: transformers' plain-torch scan sums its chunk recurrence
        # over the target chunk (``.sum(dim=2)``), exact only with one chunk
        chunk_size=256,
        intermediate_size=f, hidden_act="gelu", num_attention_heads=arch.n_heads,
        num_key_value_heads=arch.n_kv_heads, num_mem_blocks=1, adapter_rank=r,
        use_shared_attention_adapter=arch.use_shared_attention_adapter, use_mem_rope=True,
        rope_theta=arch.rope_theta, rms_norm_eps=arch.norm_eps,
        # its plain-torch path clamps dt at time_step_min; the fused kernels and the port do not
        time_step_min=1e-9, tie_word_embeddings=True, attn_implementation="eager")
    model = tf.Zamba2ForCausalLM(hc).eval()
    put = lambda mod, name, t: setattr(mod, name, torch.nn.Parameter(t.detach().clone().contiguous()))  # noqa: E731
    m = model.model
    put(m.embed_tokens, "weight", params["embed"])
    model.lm_head.weight = m.embed_tokens.weight
    put(m.final_layernorm, "weight", params["ln_f"])
    inv = {layer: j for j, layer in enumerate(arch.hybrid_layer_ids)}
    sp, ip = params["shared_block"], params["shared_inv"]
    for i, block in enumerate(m.layers):
        dec = block.mamba_decoder if i in inv else block
        s = {k: v[i] for k, v in params["layers"]["ssm"].items()}
        put(dec.input_layernorm, "weight", params["layers"]["ln1"][i])
        mx = dec.mamba
        put(mx.in_proj, "weight", s["in_proj"].T)
        put(mx.conv1d, "weight", s["conv_w"].T[:, None, :])
        put(mx.conv1d, "bias", s["conv_b"])
        for name in ("dt_bias", "A_log", "D"):
            put(mx, name, s[name])
        put(mx.norm, "weight", s["norm_w"])
        put(mx.out_proj, "weight", s["out_proj"].T)
        if i not in inv:
            continue
        j, st = inv[i], block.shared_transformer
        put(block.linear, "weight", ip["linear"][j].T)
        put(st.input_layernorm, "weight", sp["ln1"])
        put(st.pre_ff_layernorm, "weight", sp["ln2"])
        at = st.self_attn
        for n in "qkv":
            put(getattr(at, f"{n}_proj"), "weight", sp["attn"][f"w{n}"].reshape(a, -1).T)
            if arch.use_shared_attention_adapter:
                ad = getattr(at, f"linear_{n}_adapter_list")[j]
                put(ad[0], "weight", ip[f"{n}_a"][j].T)
                put(ad[1], "weight", ip[f"{n}_b"][j].reshape(r, -1).T)
        put(at.o_proj, "weight", sp["attn"]["wo"].reshape(-1, arch.d_model).T)
        ff = st.feed_forward
        put(ff.gate_up_proj, "weight", torch.cat([sp["ffn"]["w_gate"], sp["ffn"]["w_up"]], 1).T)
        put(ff.down_proj, "weight", sp["ffn"]["w_down"].T)
        ad = ff.gate_up_proj_adapter_list[j]  # transformers always has it: a port without it is zeros there
        put(ad[0], "weight", ip["ffn_a"][j].T if arch.use_shared_mlp_adapter else torch.zeros(r, arch.d_model))
        put(ad[1], "weight", ip["ffn_b"][j].T if arch.use_shared_mlp_adapter else torch.zeros(2 * f, r))
    return model


@pytest.mark.parametrize("mlp,att", FLAGS)
def test_port_matches_transformers_zamba2(mlp, att):
    arch = _arch(mlp, att)
    params = init_params(torch.Generator().manual_seed(0), arch)
    model = _hf_model(params, arch)
    for prompt, served in _requests(seed=7):
        with torch.no_grad():
            want = model(torch.tensor([prompt + served[:-1]]), use_cache=False).logits[0, len(prompt) - 1:]
        got = _served(params, arch, prompt, served)
        assert (want - got).abs().max() <= TOL * want.abs().max()


# The logits zamba2-1.2b's smoke model gave before the zamba2 layout was
# added (the first 6 of each row: 2 requests, a prefill and 3 decode steps)
PINNED = [[-0.965165, 0.20966, 0.56142, -0.160277, -0.314646, 1.9003],
          [-0.382276, 0.725121, 0.252102, 0.299525, 0.631467, 0.114542],
          [0.827242, 1.340235, -0.213143, 0.725434, -0.16393, -0.602945],
          [0.575957, -0.275188, 0.466043, 0.456995, -1.111273, -1.570523],
          [-0.31388, 0.510147, 0.466684, 0.415998, -1.224663, -1.146142],
          [0.112995, -0.224926, -1.023746, -1.018922, 1.229244, -0.280662],
          [0.169628, -1.591251, 1.026058, -1.686873, 0.389774, 0.363238],
          [-0.163682, -1.410173, -1.549573, 0.566289, -1.248493, -0.37555]]


def test_the_residual_layout_is_unchanged():
    arch = get_smoke_config("zamba2-1.2b").variant(dtype="float32")
    assert not zamba2_layout(arch) and shared_layers(arch) == (0, 2)
    params = init_params(torch.Generator().manual_seed(0), arch)
    cache = init_cache(arch, 2, 32, "cpu")
    toks = torch.tensor([[3, 17, 42, 9, 200, 11, 5, 77, 1, 64, 128, 33, 2],
                         [8, 6, 250, 31, 4, 4, 19, 90, 7, 60, 12, 100, 44]])
    with torch.inference_mode():
        logits, cache = prefill(params, arch, {"tokens": toks}, cache)
        out = [logits[:, 0]]
        for i, t in enumerate([[5, 6], [70, 71], [199, 3]]):
            logits, cache = decode_step(params, arch, torch.tensor(t)[:, None],
                                        torch.tensor([13 + i] * 2, dtype=torch.int32), cache)
            out.append(logits[:, 0])
    got = torch.stack(out, 1).reshape(8, -1)[:, :6]
    assert torch.allclose(got, torch.tensor(PINNED), rtol=0, atol=2e-6)  # printed to 6 decimals


def test_published_sizes_and_parameter_count():
    arch = get_config(NAME)
    assert (arch.n_layers, arch.d_model, arch.n_heads, arch.resolved_head_dim) == (38, 2048, 32, 128)
    assert shared_layers(arch) == (6, 12, 18, 24, 30, 36) and arch.tie_embeddings
    assert 1.19e9 <= arch.param_count() <= 1.21e9
    smoke = _arch()
    params = init_params(torch.Generator().manual_seed(0), smoke)
    assert sum(t.numel() for t in _leaves(params)) == smoke.param_count()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_shared_block_invocations_are_counted():
    arch = _arch()
    params = init_params(torch.Generator().manual_seed(0), arch)
    cache = init_cache(arch, 8, 32, "cpu")
    n = len(arch.hybrid_layer_ids)
    with torch.inference_mode():
        before = obs.counters["shared_block"]
        prefill(params, arch, {"tokens": torch.randint(0, 256, (8, 11))}, cache)
        assert obs.counters["shared_block"] - before == n
        decode_step(params, arch, torch.randint(0, 256, (8, 1)), torch.full((8,), 11, dtype=torch.int32), cache)
        assert obs.counters["shared_block"] - before == 2 * n


def test_training_and_a_fleet_are_refused():
    from repro_torch.serve import Fleet

    arch = _arch()
    params = init_params(torch.Generator().manual_seed(0), arch)
    with pytest.raises(NotImplementedError, match="not trained"):
        forward_train(params, arch, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="fleet"):
        Fleet(arch, params)
