"""The port's blinded qualitative study (``pipelines/qual_study.py``, the
``prepare_qual_images`` CLI) against the JAX package's: ``build_panel`` from
the converted JAX init, ``score_panels``' CSV (the empty run too),
``save_panel``, the CLI on the CPU with ``--score``, and the ``cuda``
default raising without a card.

``build_panel`` on the 24 x 24 structured case (hidden 48, 2 layers, 5
fine-tune steps): phase 1 is the port's plain K1-a against the JAX
package's autodiff, float32 in another order, so the threshold sits where
the JAX trace drops by 1% below every earlier step and both stop at the
same step. Gaps read on the CPU before the bars were set: base 0 (bar 1e-6),
low 1.2e-7 and interpolated 1.8e-7 (bar 1e-6), SR 4.8e-7 (bar 1e-5, the
soft-ERD recon bar); the ADC maps 8.0e-7 at most against values up to 0.69
(bar 1e-5). The ADC is a log of a ratio, so its bar holds only where the
image and the b0 stand well above zero: every image of this case is at
least 0.20 and its b0 at least 0.4, and the test requires 0.1 of both. The
arm order is equal.
The scores CSV holds 5 decimals of the same panel on both sides.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_super_resolution_tpu.config import INRERDConfig as JINRERDConfig
from mri_super_resolution_tpu.core import interp as jinterp
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit.engine import plain_apply_init as j_plain_apply_init
from mri_super_resolution_tpu.models import SirenERD as JSirenERD
from mri_super_resolution_tpu.pipelines import qual_study as jqs
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import prepare_qual_images as qual_cli
from mri_super_resolution_tpu_torch.config import INRERDConfig
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
from mri_super_resolution_tpu_torch.pipelines import qual_study
from test_torch_lowres_qual import SLICE, _structured_case, _write_volume

torch.set_num_threads(2)

HIDDEN, LAYERS, SEED, FINE_TUNE = 48, 2, 291, 5


def _threshold(jmodel, p0, case) -> float:
    """A phase-1 threshold where the JAX loss trace on the panel's low arm
    drops 1% below every earlier step (between steps 120 and 200)."""
    base = case.b3[:, :, SLICE, :].mean(-1)
    low = jinterp.rescale(jnp.asarray(base), 0.5, anti_aliasing=True)
    coords, target = jmgrid(low.shape), low.reshape(-1, 1)
    apply_fn, _ = j_plain_apply_init(jmodel)
    tx = optax.adam(JINRERDConfig.pretrain_lr)
    state, params = tx.init(p0), p0
    vg = jax.jit(jax.value_and_grad(lambda p: jnp.mean((apply_fn(p, coords) - target) ** 2)))
    trace = []
    for _ in range(200):
        loss, g = vg(params)
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
        trace.append(float(loss))
    trace = np.asarray(trace)
    k = next(i for i in range(120, 200) if trace[i] < 0.99 * trace[:i].min())
    return float(trace[k]) * 1.001


def _inject_init(monkeypatch, params, steps: list):
    """The port's phase 1 starts from the JAX init (converted); a restart
    would ask for a second init and fail. ``steps`` gets phase 1's count."""
    real_init, real_fit = qual_study.plain_apply_init, qual_study.fit_until

    def plain_apply_init(model, generator=None):
        apply_fn, _ = real_init(model, generator)

        def init_fn(k):
            assert k == 0, "phase 1 restarted"
            model.load_state_dict(convert.siren_erd_state_dict(jax.tree.map(np.asarray,
                                                                            params)))
            return model.weights()

        return apply_fn, init_fn

    def fit_until(*args, **kwargs):
        res = real_fit(*args, **kwargs)
        steps.append(res.steps)
        return res

    monkeypatch.setattr(qual_study, "plain_apply_init", plain_apply_init)
    monkeypatch.setattr(qual_study, "fit_until", fit_until)


@pytest.fixture(scope="module")
def panels():
    """The JAX panel of the structured case and the JAX init it drew."""
    jcase, tcase = _structured_case(np.random.default_rng(0))
    jmodel = JSirenERD(hidden_features=HIDDEN, hidden_layers=LAYERS, perturb=True)
    _, sub = jax.random.split(jax.random.key(SEED))  # fit_until's first init key
    p0 = jmodel.init(sub, jnp.zeros((1, 2)), 0.0, 0.0)
    kw = dict(hidden_features=HIDDEN, hidden_layers=LAYERS,
              loss_threshold=_threshold(jmodel, p0, jcase))
    want = jqs.build_panel(jcase, SLICE, JINRERDConfig(**kw), seed=SEED,
                           fine_tune_steps=FINE_TUNE)
    return want, p0, tcase, INRERDConfig(**kw)


def test_build_panel_matches_jax(monkeypatch, panels):
    want, p0, tcase, cfg = panels
    steps = []
    _inject_init(monkeypatch, p0, steps)
    sk.reset_launches()
    got = qual_study.build_panel(tcase, SLICE, cfg, seed=SEED, fine_tune_steps=FINE_TUNE,
                                 device="cpu")
    assert not any(sk.LAUNCHES.values())
    assert len(steps) == 1 and steps[0] > 120
    assert got.order == tuple(want.order)
    for name, atol in (("base", 1e-6), ("low", 1e-6), ("interpolated", 1e-6), ("sr", 1e-5),
                       ("adc_low", 1e-5), ("adc_interpolated", 1e-5), ("adc_sr", 1e-5),
                       ("adc_base", 1e-5)):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, atol=atol, err_msg=name)
    assert got.low.shape == (12, 12) and got.sr.shape == (24, 24)
    # every ADC input of this case stands well above zero (the bar's premise)
    assert min(float(getattr(got, n).min()) for n in ("low", "interpolated", "sr", "base")) > 0.1
    assert float(tcase.b0[:, :, SLICE].min()) > 0.1


def test_score_panels_matches_jax(tmp_path, panels):
    want_panel = panels[0]
    panel = qual_study.QualPanel(**{f.name: getattr(want_panel, f.name) for f in
                                    qual_study.dataclasses.fields(qual_study.QualPanel)})
    got = qual_study.score_panels({300: panel, 7: panel}, str(tmp_path / "t.csv"), device="cpu")
    want = jqs.score_panels({300: want_panel, 7: want_panel}, str(tmp_path / "j.csv"))
    got_rows = [ln.split(",") for ln in open(got).read().splitlines()]
    want_rows = [ln.split(",") for ln in open(want).read().splitlines()]
    assert got_rows[0] == want_rows[0] and len(got_rows) == len(want_rows) == 3
    assert [r[0] for r in got_rows[1:]] == ["7", "300"]
    for g, w in zip(got_rows[1:], want_rows[1:]):
        np.testing.assert_allclose([float(v) for v in g[1:]], [float(v) for v in w[1:]],
                                   atol=1.5e-5)  # one unit of the 5th decimal
    # no panels: the populated run's header all the same
    empty = qual_study.score_panels({}, str(tmp_path / "e.csv"), device="cpu")
    jempty = jqs.score_panels({}, str(tmp_path / "je.csv"))
    assert open(empty).read() == open(jempty).read() == ",".join(got_rows[0]) + "\n"


def test_save_panel_writes_png_and_label_row(tmp_path, panels):
    panel = panels[0]
    row = qual_study.save_panel(panel, str(tmp_path / "sub" / "p.png"))
    assert os.path.getsize(tmp_path / "sub" / "p.png") > 0
    assert row == {str(i + 1): arm for i, arm in enumerate(panel.order)}
    assert sorted(row.values()) == sorted(qual_study.ARMS)


def test_prepare_qual_images_cli_on_cpu(tmp_path):
    data = str(tmp_path / "data")
    _write_volume(data, seed=4)
    out = str(tmp_path / "qual")
    sk.reset_launches()
    labels = qual_cli.main(["--limit_cases", "1", "--num_acq", "3", "--fine_tune_steps", "2",
                            "--start_counter", "5", "--score", "--out_dir", out,
                            "--data_dir", data, "--device", "cpu"])
    assert not any(sk.LAUNCHES.values())
    rows = [ln.split(",") for ln in open(labels).read().splitlines()]
    assert rows[0] == list(qual_study.LABELS_HEADER) and len(rows) == 2
    assert rows[1][:2] == ["5", "18-1681-07"] and 0 <= int(rows[1][2]) < 12
    assert sorted(rows[1][3:]) == sorted(qual_study.ARMS)
    assert os.path.getsize(os.path.join(out, "5.png")) > 0
    scores = [ln.split(",") for ln in
              open(os.path.join(out, "perceptual_scores.csv")).read().splitlines()]
    assert scores[0][0] == "file" and len(scores[0]) == 22 and scores[1][0] == "5"
    assert all(np.isfinite(float(v)) for v in scores[1][1:])


def test_build_panel_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, case = _structured_case(np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="cuda"):
        qual_study.build_panel(case, SLICE)
    with pytest.raises(RuntimeError, match="cuda"):
        qual_study.score_panels({}, "unused.csv")
