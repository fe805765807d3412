"""The plain references against the port's plain path at reduced widths,
from the same weights (drawn by the benchmark), in float32 on the CPU."""
import pytest
import torch

from bench.lib import registry, serve
from bench.lib import weights as W
from bench.tests.tiny import tiny_config

CONFIGS = ["olmo-1b", "minicpm3-4b"]


def _port_logits(c, w, tokens):
    from repro_torch.models import model as M
    arch = serve.port_arch(c)
    ref = registry.reference(c["reference"])
    with torch.no_grad():
        h, _ = M.forward_hidden(arch, ref.port_tree(c, w), tokens[None], mode="train")
        return M.lm_logits(arch, ref.port_tree(c, w), h)[0, :, :c["vocab_size"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_equals_the_port(name):
    c = tiny_config(name)
    ref = registry.reference(c["reference"])
    w = W.draw(ref, c, 2 ** 33 + 5, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (37,), generator=torch.Generator().manual_seed(1))
    want = _port_logits(c, w, tokens)
    got = ref.logits(c, w, [tokens])[0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_rows_are_its_whole_forwards_rows(name):
    c = tiny_config(name)
    ref = registry.reference(c["reference"])
    w = W.draw(ref, c, 9, "cpu")
    seqs = [torch.arange(20) % c["vocab_size"], torch.arange(5, 40) % c["vocab_size"]]
    whole = ref.logits(c, w, seqs)
    rows = [torch.tensor([3, 19]), torch.tensor([0, 34])]
    part = ref.logits(c, w, seqs, rows)
    for a, b, r in zip(whole, part, rows):
        torch.testing.assert_close(a[r], b)


def test_minicpm3_scalings_are_applied():
    """The published scalings change the output unless set neutral, so the
    reference reads them (a configuration that sets them is not ignored)."""
    c = tiny_config("minicpm3-4b")
    ref = registry.reference("minicpm3")
    w = W.draw(ref, c, 4, "cpu")
    toks = [torch.arange(12)]
    base = ref.logits(c, w, toks)[0]
    for key, val in (("scale_emb", 12), ("scale_depth", 0.5), ("dim_model_base", 16)):
        other = dict(c, **{key: val})
        assert not torch.allclose(ref.logits(other, w, toks)[0], base, atol=1e-3), key


@pytest.mark.parametrize("name", CONFIGS)
def test_fp8_control_departs_further_than_float32(name):
    c = tiny_config(name)
    ref = registry.reference(c["reference"])
    w = W.draw(ref, c, 5, "cpu")
    toks = [torch.arange(30) % c["vocab_size"]]
    f32 = ref.logits(c, w, toks)[0]
    lo = ref.logits(c, w, toks, quant="fp8")[0]
    assert (lo - f32).abs().max() > 1e-3
