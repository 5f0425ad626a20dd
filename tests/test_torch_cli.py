"""samd_tpu_torch.cli on piped input, as ``tests/test_cli.py`` drives
samd_tpu.cli: every ``--engine`` on token-id turns, quantized weights and
int8 KV, the model families, the conversation commands, a local HF
directory with and without a tokenizer; and ``SamdEngine.stream_generate``,
whose chunks joined equal ``generate``'s output, greedy and sampled.  The
CLI runs in process through ``cli.main`` (one test runs ``python -m
samd_tpu_torch.cli`` as a subprocess)."""

import io
import json
import shutil
import subprocess
import sys

import pytest
import torch

from samd_tpu_torch import cli
from samd_tpu_torch.config import GenerationConfig, SamdConfig
from samd_tpu_torch.drafters import make_drafter
from samd_tpu_torch.engine import SamdEngine
from samd_tpu_torch.models import init_params, tiny_config
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--random-model", "--tiny", "--cpu", "--max-new-tokens", "8",
        "--max-cache-len", "256"]


def run_cli(monkeypatch, capsys, argv, script):
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    cli.main(argv)
    return capsys.readouterr()


def replies(out):
    return [ln.split("ASSISTANT>")[1].split("USER>")[0].split()
            for ln in out.splitlines() if "ASSISTANT>" in ln]


@pytest.mark.parametrize("engine", cli.ENGINES)
def test_cli_token_repl(monkeypatch, capsys, engine):
    r = run_cli(monkeypatch, capsys, TINY + ["--engine", engine],
                "5 6 7 8 9 10\nnot-a-token\n!!reset\n3 4 5\n!!exit\n")
    assert r.out.count("ASSISTANT>") == 2
    assert "token-id mode" in r.err
    for toks in replies(r.out):
        assert len(toks) == 8 and all(t.isdigit() for t in toks)


def test_cli_engines_agree(monkeypatch, capsys):
    """Greedy random weights: every engine's reply equals the host
    engine's (chain and tree drafts alike, in f32 on the CPU)."""
    got = {}
    for engine in cli.ENGINES:
        r = run_cli(monkeypatch, capsys, TINY + ["--engine", engine],
                    "5 6 7 8 9 10\n11 12\n!!exit\n")
        got[engine] = replies(r.out)
    assert all(v == got["samd"] for v in got.values()), got


@pytest.mark.parametrize("flags", [["--quantize", "int8"],
                                   ["--quantize", "fp8"],
                                   ["--quantize", "int4", "--kv-quant"],
                                   ["--kv-quant"]],
                         ids=["int8", "fp8", "int4-kvq", "kvq"])
def test_cli_quantized(monkeypatch, capsys, flags):
    r = run_cli(monkeypatch, capsys, TINY + ["--engine", "fused_sam"] + flags,
                "5 6 7 8 9 10\n!!exit\n")
    assert r.out.count("ASSISTANT>") == 1


@pytest.mark.parametrize("engine", ["fused_sam_eagle2", "eagle2"])
def test_cli_quantized_eagle(monkeypatch, capsys, engine):
    """A quantized target serves with a draft net quantized alike."""
    r = run_cli(monkeypatch, capsys,
                TINY + ["--engine", engine, "--quantize", "int8"],
                "5 6 7 8 9 10\n!!exit\n")
    assert r.out.count("ASSISTANT>") == 1


def test_cli_family(monkeypatch, capsys):
    r = run_cli(monkeypatch, capsys,
                TINY + ["--family", "qwen2", "--engine", "fused_hybrid"],
                "5 6 7 8 9 10\n!!exit\n")
    assert r.out.count("ASSISTANT>") == 1
    r = run_cli(monkeypatch, capsys, TINY + ["--family", "moe"],
                "5 6 7 8 9 10\n!!exit\n")
    assert r.out.count("ASSISTANT>") == 1 and len(replies(r.out)[0]) == 8


def test_cli_conversation_commands(monkeypatch, capsys, tmp_path):
    """!!remove / !!regen / !!save / !!load, as the reference's REPL."""
    save = tmp_path / "conv.json"
    script = ("5 6 7 8 9 10\n11 12 13\n!!regen\n"
              f"!!save {save}\n!!remove\n!!load {save}\n"
              "!!remove\n!!remove\n!!remove\n3 4 5\n!!exit\n")
    r = run_cli(monkeypatch, capsys, TINY + ["--engine", "fused_sam"], script)
    assert r.out.count("ASSISTANT>") == 4
    got = replies(r.out)
    assert got[1] == got[2]          # a greedy regen repeats its answer
    assert "saved 2 turns" in r.err and "loaded 2 turns" in r.err
    assert "nothing to remove" in r.err
    turns = json.loads(save.read_text())
    assert len(turns) == 2 and turns[0][0] == [5, 6, 7, 8, 9, 10]


def test_cli_refuses_bad_ids_and_goes_on(monkeypatch, capsys):
    r = run_cli(monkeypatch, capsys, TINY, "5 999\n5 6 7\n!!exit\n")
    assert "refused" in r.err and "999" in r.err
    assert len(replies(r.out)[-1]) == 8


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny HF Llama directory (eos 2 in config.json) and a copy with a
    word-level tokenizer."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import (LlamaConfig, LlamaForCausalLM,
                              PreTrainedTokenizerFast)

    d = tmp_path_factory.mktemp("hf")
    torch.manual_seed(7)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-6, eos_token_id=2,
        tie_word_embeddings=False)).save_pretrained(str(d / "ids"))
    shutil.copytree(d / "ids", d / "text")
    vocab = {f"w{i}": i for i in range(250)}
    vocab.update({"<unk>": 250, "<s>": 251, "</s>": 2})
    vocab["w2"] = 252
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            bos_token="<s>", eos_token="</s>"
                            ).save_pretrained(str(d / "text"))
    return d


def test_cli_model_dir_token_ids(monkeypatch, capsys, hf_dir):
    """--model without a tokenizer: token-id mode with a notice, replies
    equal to the same engine's generate in process (multi-turn included)."""
    model = str(hf_dir / "ids")
    argv = ["--model", model, "--cpu", "--engine", "fused_sam",
            "--max-new-tokens", "10", "--max-cache-len", "256"]
    r = run_cli(monkeypatch, capsys, argv, "5 6 7 8\n9 10 11\n!!exit\n")
    assert "holds no tokenizer" in r.err
    got = [[int(t) for t in toks] for toks in replies(r.out)]
    engine, tok, eos = cli.build_engine(cli.parse_args(argv))
    assert tok is None and eos == 2
    gen = GenerationConfig(max_new_tokens=10, max_cache_len=256)
    first = engine.generate([5, 6, 7, 8], gen).output_ids[4:]
    second_prompt = [5, 6, 7, 8] + first + [9, 10, 11]
    second = engine.generate(second_prompt, gen).output_ids[
        len(second_prompt):]
    assert got == [first, second]


def test_cli_and_server_share_the_model(hf_dir, tmp_path):
    """The CLI and the server build one model through
    ``loader.build_params``: with no end token in config.json both take
    the tokenizer's; ``--family`` reaches the server too."""
    import argparse

    from samd_tpu_torch.server import build_server_engine

    d = tmp_path / "text"
    shutil.copytree(hf_dir / "text", d)
    cfg = json.loads((d / "config.json").read_text())
    del cfg["eos_token_id"]
    (d / "config.json").write_text(json.dumps(cfg))
    _, _, eos = cli.build_engine(cli.parse_args(
        ["--model", str(d), "--cpu", "--max-cache-len", "256"]))
    base = dict(model=None, random_model=False, tiny=False, family="llama",
                engine="fused_sam_batched", batch_size=2, quantize=None,
                max_cache_len=256, sam=None, cpu=True)
    server = build_server_engine(argparse.Namespace(**{**base,
                                                       "model": str(d)}))
    assert eos == server.eos_token_id == 2
    qwen = build_server_engine(argparse.Namespace(**{
        **base, "random_model": True, "tiny": True, "family": "qwen2"}))
    assert qwen.model_cfg.attn_bias and "bq" in qwen.params["layers"]


def test_cli_model_dir_text(monkeypatch, capsys, hf_dir):
    """--model with a tokenizer: text in, decoded text out."""
    r = run_cli(monkeypatch, capsys,
                ["--model", str(hf_dir / "text"), "--cpu",
                 "--max-new-tokens", "6", "--max-cache-len", "256"],
                "w5 w6 w7 w8\n!!exit\n")
    assert "token-id mode" not in r.err
    words = replies(r.out)[0]
    assert 1 <= len(words) <= 6 and all(w.startswith("w") for w in words)


def test_cli_subprocess():
    r = subprocess.run(
        [sys.executable, "-m", "samd_tpu_torch.cli", *TINY,
         "--engine", "pld"],
        input="5 6 7 8 9 10\n!!exit\n", capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("ASSISTANT>") == 1


# ---------------------------------------------------------------------------
# stream_generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_engine():
    cfg = tiny_config(vocab_size=128)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, scale=0.4, device="cpu")
    scfg = SamdConfig(draft_source="sam_only", max_predicts=8, len_bias=0)
    return SamdEngine(cfg, params, scfg, make_drafter(scfg, 128),
                      max_cache_len=256, eos_token_id=-1,
                      prefill_buckets=(32, 64), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=30),
    dict(max_new_tokens=7),
    dict(max_new_tokens=24, greedy=False, temperature=0.9, seed=3),
    dict(max_new_tokens=24, greedy=False, temperature=0.7, top_p=0.8,
         accept_mode="nucleus", seed=5)],
    ids=["greedy", "cut", "rejection", "nucleus"])
def test_stream_generate_equals_generate(host_engine, kw):
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 9]
    gen = GenerationConfig(max_cache_len=256, **kw)
    chunks = list(host_engine.stream_generate(prompt, gen))
    want = host_engine.generate(prompt, gen)
    assert all(chunks)
    assert sum(chunks, []) == want.output_ids[len(prompt):]
    assert len(chunks) >= want.decode_steps - 1


def test_stream_generate_stops_at_eos(host_engine):
    """An end token cuts the stream where generate cuts its output."""
    prompt = [5, 6, 7, 8, 9]
    gen = GenerationConfig(max_new_tokens=20, max_cache_len=256)
    free = host_engine.generate(prompt, gen).output_ids[len(prompt):]
    host_engine.eos_token_id = free[5]
    try:
        chunks = list(host_engine.stream_generate(prompt, gen))
        want = host_engine.generate(prompt, gen).output_ids[len(prompt):]
    finally:
        host_engine.eos_token_id = -1
    assert sum(chunks, []) == want and want[-1] == free[5]
    assert len(want) <= 6
