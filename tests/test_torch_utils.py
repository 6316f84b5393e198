"""The port's utilities (`cvc_tpu_torch/utils/`) on the CPU against the JAX
package's (`cvc_tpu/utils/`): the non-finite report counts the same
entries on the same trees (paths as 'a/b/c' instead of JAX key strings),
the NaN-checked loss flags the loss the JAX checkify flags, the step
timer keeps the same measures, the profiler writes a Chrome trace, and the
attention summaries and JSON files are equal (no tolerance: the same
numpy)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvc_tpu.utils import debug as jdebug
from cvc_tpu.utils import visualize as jvis
from cvc_tpu_torch.utils import debug, profiling, visualize


def _trees():
    a = np.array([1.0, np.nan], np.float32)
    c = np.array([np.inf, 2.0, np.nan], np.float32)
    return ({"a": jnp.asarray(a), "b": {"c": jnp.asarray(c)},
             "ints": jnp.array([1, 2])},
            {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c)},
             "ints": torch.tensor([1, 2]),
             "layers": [{"w": torch.tensor([np.nan])}]})


def test_nonfinite_report_counts_as_jax():
    jt, tt = _trees()
    want = jdebug.tree_nonfinite_report(jt)
    got = debug.tree_nonfinite_report(tt)
    assert got == {"a": 1, "b/c": 2, "layers/0/w": 1}
    assert sum(want.values()) == got["a"] + got["b/c"]


def test_assert_tree_finite():
    debug.assert_tree_finite({"x": torch.ones(3), "n": torch.tensor([1])})
    with pytest.raises(FloatingPointError, match="params"):
        debug.assert_tree_finite({"x": torch.tensor([float("nan")])},
                                 what="params")


@pytest.mark.parametrize("x", [[-1.0, 2.0], [1.0, 2.0]])
def test_checkify_loss_flags_what_jax_flags(x):
    jerr, jval = jdebug.checkify_loss(lambda v: jnp.log(v).sum())(
        jnp.asarray(x))
    err, val = debug.checkify_loss(lambda v: torch.log(v).sum())(
        torch.tensor(x))
    try:
        jerr.throw()
        jax_flags = False
    except Exception:
        jax_flags = True
    if jax_flags:
        with pytest.raises(FloatingPointError, match="log"):
            err.throw()
    else:
        err.throw()
        np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    assert jax_flags == (x[0] < 0)


def test_checkify_loss_ignores_a_nan_it_was_given():
    err, _ = debug.checkify_loss(lambda v: (v * 2).sum())(
        torch.tensor([float("nan"), 1.0]))
    err.throw()


def test_step_timer_keeps_measures_after_warmup():
    t = profiling.StepTimer(warmup=2)
    for _ in range(5):
        with t.measure(torch.ones(2)):
            pass
    assert len(t.times) == 3
    assert t.best <= t.mean
    assert np.isnan(profiling.StepTimer().mean)
    t.block_and_record({"x": [torch.zeros(1)]})


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with profiling.trace_context(str(tmp_path / "tr")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    trace = json.load(open(tmp_path / "tr" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    with profiling.trace_context(None) as prof:
        pass
    assert prof is None


def _attention(seed=0):
    rng = np.random.default_rng(seed)
    words = ["a", "dog", "on", "grass"]
    attn = rng.random((5, 6)).astype(np.float32)
    boxes = rng.random((6, 5)).astype(np.float32)
    return words, attn, boxes


@pytest.mark.parametrize("top_k", [1, 3])
def test_attention_summary_and_json_equal_jax(tmp_path, top_k):
    words, attn, boxes = _attention(top_k)
    assert (visualize.attention_summary(words, attn, boxes, top_k)
            == jvis.attention_summary(words, attn, boxes, top_k))
    visualize.save_attention_json(str(tmp_path / "p" / "a.json"), "img1",
                                  words, attn, boxes, top_k)
    jvis.save_attention_json(str(tmp_path / "j" / "a.json"), "img1",
                             words, attn, boxes, top_k)
    assert (json.load(open(tmp_path / "p" / "a.json"))
            == json.load(open(tmp_path / "j" / "a.json")))


def test_render_attention_png_where_matplotlib_imports(tmp_path):
    words, attn, boxes = _attention()
    path = tmp_path / "v" / "a.png"
    drawn = visualize.render_attention_png(str(path), words, attn, boxes,
                                           object_words={"dog", "grass"})
    try:
        import matplotlib  # noqa: F401
        assert drawn and path.stat().st_size > 0
    except ImportError:
        assert drawn is False and not path.exists()
