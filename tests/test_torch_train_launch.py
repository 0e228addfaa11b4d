"""The port's training launcher and registry (``repro_torch.launch.train``,
``repro_torch.configs.registry``) against the reference's.

* The reference's ``test_failure_restart_via_launcher`` on the port:
  ``--die-at-step 5`` exits 42, the rerun prints ``[restore] resumed
  from step 4`` and exits 0; the resumed run's losses EQUAL an
  uninterrupted run's (deterministic mode); the previous deterministic
  setting is restored; without ``--device cpu`` there is no card here
  and the launcher fails (no fallback to the CPU).
* The launcher's checkpoint restores into the reference's own state
  template (its names, shapes and dtypes).
* ``test_reduced_smoke_train_step`` for the five LM ids: one step
  through the registry and ``reduced_arch`` gives a finite loss and
  moves every parameter leaf; ``reduced_arch`` equals the reference's
  field by field (dtypes by name).
* The other five ids (nequip, sasrec, dcn-v2, fm, autoint) resolve in
  their families; each trains through ``--reduced --device cpu``; its
  ``reduced_arch`` equals the reference's field by field; nequip and
  sasrec resume from ``--die-at-step`` with the uninterrupted run's
  losses EQUAL, and a nequip checkpoint restores into the reference's
  state template.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.launch import train as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

LM_IDS = ("llama3.2-3b", "granite-moe-3b-a800m", "deepseek-7b",
          "qwen2-72b", "kimi-k2-1t-a32b")
LATER_IDS = ("nequip", "sasrec", "dcn-v2", "fm", "autoint")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args):
    """(return code, stdout) of the launcher in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = TL.main(args)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _losses(stdout):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step\s+(\d+) loss (\S+) gnorm (\S+)", stdout)}


ARGS = ["--arch", "llama3.2-3b", "--reduced", "--steps", "8", "--batch",
        "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "1",
        "--device", "cpu"]


def test_failure_restart_via_launcher(tmp_path):
    """Kill the training loop mid-run, restart, verify resume: the
    resumed steps print the uninterrupted run's losses and norms."""
    rc, out = _run(ARGS + ["--ckpt-dir", str(tmp_path / "a"),
                           "--die-at-step", "5"])
    assert rc == 42  # simulated node failure
    assert "[failure-sim] dying at step 5" in out
    rc, resumed = _run(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    assert rc == 0  # restart resumes from step 4 and finishes
    assert "[restore] resumed from step 4" in resumed
    assert resumed.rstrip().endswith("[done]")
    rc, whole = _run(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert rc == 0 and "[restore]" not in whole
    got, want = _losses(resumed), _losses(whole)
    assert sorted(got) == [5, 6, 7, 8]
    assert all(got[s] == want[s] for s in got)
    assert {s: _losses(out)[s] for s in range(1, 6)} == \
        {s: want[s] for s in range(1, 6)}
    assert not torch.are_deterministic_algorithms_enabled()


def test_launcher_without_a_card_fails():
    """The default device is the card: with none, no fallback."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        TL.main(ARGS[:-2])
    assert not torch.are_deterministic_algorithms_enabled()


def test_launcher_checkpoint_restores_in_reference(tmp_path):
    """The launcher's last checkpoint (reduced llama, AdamW) restores into
    the reference launcher's own state template, leaf for leaf."""
    rc, _ = _run(ARGS[:3] + ["--steps", "2", "--batch", "2", "--seq", "8",
                             "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert rc == 0
    arch = JL.reduced_arch(JR.get("llama3.2-3b"))
    key = jax.random.PRNGKey(0)
    template = JTR.init_state(key, JT.init_params(key, arch.cfg),
                              arch.train_cfg)
    state, extra = JCK.CheckpointManager(str(tmp_path)).restore(template)
    assert extra == {"seed": 0}
    assert int(state.step) == 2
    assert np.asarray(state.rng).tolist() == [0, 0]
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(state.params))


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_reduced_arch_matches_reference(arch_id):
    got, want = TL.reduced_arch(TR.get(arch_id)), JL.reduced_arch(
        JR.get(arch_id))
    assert got.family == want.family == "transformer"
    for f in dataclasses.fields(want.cfg):
        a, b = getattr(got.cfg, f.name, None), getattr(want.cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif f.name == "moe":
            assert (a is None) == (b is None)
            if b is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif f.name != "use_scan":  # the port loops over layers
            assert a == b, f.name
    assert got.train_cfg.microbatches == want.train_cfg.microbatches == 1
    assert (got.train_cfg.opt.warmup_steps, got.train_cfg.opt.total_steps) \
        == (want.train_cfg.opt.warmup_steps, want.train_cfg.opt.total_steps)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_reduced_smoke_train_step(arch_id):
    arch = TL.reduced_arch(TR.get(arch_id))
    params = TT.init_params(torch.Generator().manual_seed(0), arch.cfg,
                            device="cpu")
    before = convert.params_to_numpy(params)
    state = TTR.init_state(0, params, arch.train_cfg)
    step = TTR.make_train_step(arch.loss_fn(), arch.train_cfg)
    batch = TL.make_stream(arch, 4, 64, seed=0).next()
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert abs(float(m["loss"]) - (np.log(arch.cfg.vocab) + 0.5)) < 1.0
    assert int(state.step) == 1
    after = convert.params_to_numpy(state.params)
    flat_b = jax.tree_util.tree_flatten_with_path(before)[0]
    flat_a = jax.tree_util.tree_leaves(after)
    for (path, b), a in zip(flat_b, flat_a, strict=True):
        assert not np.array_equal(a, b), jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch_id", LATER_IDS)
def test_later_families_name_item_13c(arch_id):
    """The item-13c ids resolve in the reference's families (the
    registry holds all ten reference ids)."""
    assert sorted(TR.ARCHS) == sorted(JR.ARCHS)
    arch = TR.get(arch_id)
    assert arch.family == JR.get(arch_id).family
    assert arch.model.__name__ == f"repro_torch.models.{arch.family}"
    with pytest.raises(KeyError, match="unknown"):
        TR.get("no-such-arch")


def _fields_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("arch_id", LATER_IDS)
def test_reduced_later_arch_matches_reference(arch_id):
    got, want = TL.reduced_arch(TR.get(arch_id)), JL.reduced_arch(
        JR.get(arch_id))
    _fields_equal(got.cfg, want.cfg)
    _fields_equal(TR.get(arch_id).cfg, JR.get(arch_id).cfg)
    assert (got.train_cfg.opt.name, got.train_cfg.opt.lr) == \
        (want.train_cfg.opt.name, want.train_cfg.opt.lr) == ("adamw", 1e-3)
    assert (got.train_cfg.opt.warmup_steps, got.train_cfg.opt.total_steps,
            got.train_cfg.microbatches) == (
        want.train_cfg.opt.warmup_steps, want.train_cfg.opt.total_steps, 1)


def _later_args(arch_id, steps=6):
    return ["--arch", arch_id, "--reduced", "--steps", str(steps),
            "--batch", "16", "--ckpt-every", "2", "--log-every", "1",
            "--device", "cpu"]


@pytest.mark.parametrize("arch_id", LATER_IDS)
def test_reduced_later_arch_trains_via_launcher(arch_id, tmp_path):
    rc, out = _run(_later_args(arch_id, steps=4))
    assert rc == 0 and out.rstrip().endswith("[done]")
    losses = _losses(out)
    assert sorted(losses) == [1, 2, 3, 4]
    assert all(np.isfinite(float(v)) for v in losses.values())


@pytest.mark.parametrize("arch_id", ["nequip", "sasrec"])
def test_later_arch_restart_repeats_losses(arch_id, tmp_path):
    args = _later_args(arch_id)
    rc, out = _run(args + ["--ckpt-dir", str(tmp_path / "a"),
                           "--die-at-step", "3"])
    assert rc == 42 and "[failure-sim] dying at step 3" in out
    rc, resumed = _run(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert rc == 0 and "[restore] resumed from step 2" in resumed
    rc, whole = _run(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert rc == 0
    got, want = _losses(resumed), _losses(whole)
    assert sorted(got) == [3, 4, 5, 6]
    assert all(got[s] == want[s] for s in got)
    assert {s: _losses(out)[s] for s in (1, 2, 3)} == \
        {s: want[s] for s in (1, 2, 3)}


def test_nequip_checkpoint_restores_in_reference(tmp_path):
    """A nequip checkpoint of the launcher (the reference's leaf names:
    ``layers/[i]/['self']/[l]``...) restores into the reference
    launcher's state template."""
    rc, _ = _run(_later_args("nequip", steps=2)
                 + ["--ckpt-dir", str(tmp_path)])
    assert rc == 0
    arch = JL.reduced_arch(JR.get("nequip"))
    from repro.models import nequip as JN

    key = jax.random.PRNGKey(0)
    template = JTR.init_state(key, JN.init_params(key, arch.cfg),
                              arch.train_cfg)
    state, extra = JCK.CheckpointManager(str(tmp_path)).restore(template)
    assert extra == {"seed": 0} and int(state.step) == 2
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(state.params))
