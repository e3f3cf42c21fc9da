"""Each reference against the port at small widths on the CPU, from the
same weights (the benchmark's own, in the port's layout) and inputs."""
import pytest
import torch

from bench.harness import compare, inputs
from bench.harness import params as weights
from bench.harness.systems import Port, first_grad_norms
from bench.reference import recsys as ref
from bench.reference.train import Trainer

XDEEPFM = {"name": "x", "interaction": "cin", "n_tables": 5, "vocab": 50, "embed_dim": 4,
           "hotness": 2, "pooling": "sum", "cin_layers": [6, 7], "dnn_widths": [9, 5],
           "dtype": "float32"}
RMC2 = {"name": "d", "interaction": "dot", "n_tables": 3, "vocab": 40, "embed_dim": 4,
        "hotness": 3, "pooling": "sum", "n_dense": 6, "dense_fc": [8, 4],
        "predict_fc": [7, 1], "dtype": "float32"}
HP = {"adagrad_lr": 0.02, "adam_lr": 1e-3, "clip_norm": 10.0}


def _batch(model, rows, seed=3, label=False):
    gen = inputs.generator(seed, "cpu")
    out = {"sparse": inputs.zipf_ids(gen, (rows, model["n_tables"], model["hotness"]),
                                     model["vocab"])}
    if model["interaction"] == "dot":
        out["dense"] = inputs.dense(gen, rows, model["n_dense"])
    if label:
        out["label"] = inputs.labels(gen, rows)
    return out


@pytest.mark.parametrize("model", [XDEEPFM, RMC2], ids=["cin", "dot"])
def test_forward_matches_port(model, monkeypatch):
    params = weights.init(model, 11, "cpu")
    batch = _batch(model, 37)
    with torch.no_grad():
        want = Port().bulk(params, model)(batch)
    monkeypatch.setattr(ref, "rows_a_block", lambda m: 10)     # blocks of 10 rows
    got = ref.forward(params, model, batch)
    assert got.shape == (37,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", [XDEEPFM, RMC2], ids=["cin", "dot"])
def test_train_steps_match_port(model, monkeypatch):
    monkeypatch.setattr(ref, "rows_a_block", lambda m: 16)
    batches = [_batch(model, 48, seed=s, label=True) for s in (1, 2, 3)]
    sides = []
    for trainer in (Port().trainer(None, model, HP), Trainer(model, **HP)):
        p = weights.init(model, 5, "cpu")
        state = trainer.init(p)
        losses, g1 = [], None
        for k, b in enumerate(batches):
            p, state, m = trainer.step(p, state, b)
            losses.append(float(m["loss"]))
            if k == 0:
                g1 = first_grad_norms(state)
        sides.append((losses, g1, dict(weights.leaves(p))))
    (lp, gp, pp), (lr, gr, pr) = sides
    assert lp == pytest.approx(lr, rel=1e-5)
    assert gp.keys() == gr.keys() and all(gp[k] == pytest.approx(gr[k], rel=1e-4, abs=1e-7)
                                          for k in gr)
    for k in pr:
        torch.testing.assert_close(pp[k], pr[k], rtol=1e-4, atol=1e-6)


def _zeroed(tree, leaf):
    """``tree`` with every leaf whose path ends in ``leaf`` set to zeros."""
    return {k: _zeroed_at(v, leaf, f"[{k!r}]") for k, v in tree.items()}


def _zeroed_at(t, leaf, path):
    if isinstance(t, dict):
        return {k: _zeroed_at(v, leaf, f"{path}[{k!r}]") for k, v in t.items()}
    if isinstance(t, list):
        return [_zeroed_at(v, leaf, f"{path}[{i}]") for i, v in enumerate(t)]
    return torch.zeros_like(t) if path.endswith(leaf) else t


@pytest.mark.parametrize("model,leaf", [(XDEEPFM, "['b']"), (XDEEPFM, "['lin_w']"),
                                        (RMC2, "['b']")], ids=["cin-bias", "cin-linear", "dot-bias"])
def test_scores_see_a_dropped_bias_or_linear_logit(model, leaf):
    # the bulk cells' score_gap limit is 1e-4: a pass that leaves out the
    # bias adds or the linear logit reads far above it
    params = weights.init(model, 11, "cpu")
    batch = _batch(model, 64)
    want = ref.forward(params, model, batch)
    got = ref.forward(_zeroed(params, leaf), model, batch)
    assert compare.score_gap(got, want) > 1e-2
