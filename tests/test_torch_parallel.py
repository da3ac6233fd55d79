"""The port's data parallel (`parallel/`) against the JAX package's
2-device CPU mesh, on gloo gangs of spawned CPU processes.

Each gang is `parallel/mesh.py spawn_cpu_gang` over a `FileStore` in the
test's own temporary directory (never a port, so gangs of parallel test
workers cannot meet), bounded by the gang's timeout: a rank that fails,
dies or outlives it fails the test. The ranks run
`tests/torch_parallel_workers.py`, which imports no JAX; this module
makes the seeded numpy inputs and the JAX side, whose 2-device mesh is
two of the 8 host devices that `tests/conftest.py` forces.

Tolerances and why:
  * global loss at rel 1e-5 and its gradients at rel 1e-5 of the
    largest element (fp32, another summation order);
  * B4's plain version with an offset at rtol 1e-6 / atol 1e-5 (the
    same fp32 formula);
  * train steps: loss at rel 2e-5, ERN gradients at rtol 1e-4 plus 1e-4
    of the tensor's largest element (`tests/test_torch_train.py`) plus
    1e-6 of the largest gradient (a tiny gradient is a sum with
    cancellation, whose rounding is that of its terms), the
    parameters after one Adam step at atol 2e-5 (lr 1e-5), BatchNorm
    running statistics at atol 1e-5;
  * retrieval: rows equal, scores within 1e-5 (JAX and the port's
    unsharded program); mesh encodes within 2e-5 of the unsharded ones;
  * the two layouts of one 2-shard mesh (one process standing for two
    shards, two ranks with one): bit for bit where both run the same
    operations (local negatives); with global negatives (one B4 call
    over the process's rows) the loss at rel 1e-6, the gradients at
    rtol 1e-4 plus 1e-6 of the largest gradient, the parameters at 2 lr
    (Adam's first update is lr x sign(g), and a zero gradient's sign is
    its rounding noise).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as W
from fashionern_aaai2024_tpu.models.clip import config as jax_config
from fashionern_aaai2024_tpu.ops import losses as JL
from fashionern_aaai2024_tpu.parallel import mesh as jmesh
from fashionern_aaai2024_tpu.retrieval import engine as JEng
from fashionern_aaai2024_tpu.retrieval import evaluate as JE
from fashionern_aaai2024_tpu.tools.make_fixture import make_fixture as jax_make_fixture
from fashionern_aaai2024_tpu.train import step as JStep
from fashionern_aaai2024_tpu.train.state import create_train_state as jax_create_state
from fashionern_aaai2024_tpu_torch.cli import main as cli
from fashionern_aaai2024_tpu_torch.models import convert
from fashionern_aaai2024_tpu_torch.models.clip import config as torch_config
from fashionern_aaai2024_tpu_torch.ops import losses as TL
from fashionern_aaai2024_tpu_torch.parallel import mesh as M
from fashionern_aaai2024_tpu_torch.parallel import multiprocess as MP
from fashionern_aaai2024_tpu_torch.train import step as TStep
from torch_port_helpers import (
    CTX,
    D,
    PATCH_NUM,
    jax_model_and_variables,
    port_model,
    small_config,
    tiny_config,
)

torch.set_num_threads(2)

GANG_TIMEOUT = 240.0
B = 8            # global train batch: 4 rows a rank on the 2-rank mesh


def gang(tmp_path, n, fn, *args):
    return M.spawn_cpu_gang(n, fn, *args, timeout=GANG_TIMEOUT, store_dir=str(tmp_path))


def _rel(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# --- the mesh helpers ------------------------------------------------------------


def test_one_process_mesh_is_the_identity():
    mesh = M.create_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1, None)
    x = torch.arange(6.0).reshape(3, 2)
    assert M.all_gather_rows(mesh, x) is x and M.all_gather_cols(mesh, x) is x
    assert torch.equal(M.all_reduce_mean(mesh, x.clone()), x)
    assert torch.equal(M.broadcast(mesh, x.clone()), x)
    with pytest.raises(ValueError, match="requested 2 devices"):
        M.create_mesh(2)


def test_one_process_mesh_defaults_to_the_card(monkeypatch):
    """No group and no device: the mesh is on the card, and without CUDA
    it raises; a CPU mesh is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested but not available"):
        M.create_mesh()
    assert M.create_mesh(device="cpu").device == torch.device("cpu")


def test_shard_batch_takes_contiguous_rows():
    mesh = M.ProcessMesh(None, 1, 2, torch.device("cpu"))
    batch = {"a": np.arange(8, dtype=np.float32).reshape(4, 2),
             "ids": np.arange(4, dtype=np.int32), "names": ["w", "x", "y", "z"]}
    out = M.shard_batch(mesh, batch)
    assert torch.equal(out["a"], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
    assert out["ids"].dtype == torch.int64 and out["ids"].tolist() == [2, 3]
    assert out["names"] == ["y", "z"]
    assert M.local_batch_size(8, mesh) == jmesh.local_batch_size(8, jmesh.create_mesh(2))
    with pytest.raises(ValueError, match="not divisible"):
        M.local_batch_size(7, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.local_batch_size(7, jmesh.create_mesh(2))


def test_initialize_distributed_needs_a_coordinator_for_many_ranks(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        M.initialize_distributed(num_processes=2, process_id=0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_gang_fails_when_a_rank_raises(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        gang(tmp_path, 2, W.raising_rank)


def test_gang_fails_at_its_timeout(tmp_path):
    with pytest.raises(RuntimeError, match="outlived its 8.0 s timeout"):
        M.spawn_cpu_gang(2, W.sleeping_rank, 120.0, timeout=8.0, store_dir=str(tmp_path))


def test_gather_rows_gradient_is_the_reduce_scatter_of_the_sum(tmp_path):
    """JAX's transpose of a tiled all_gather: rank r's rows receive the
    sum over ranks of the gradient at rows r*b:(r+1)*b."""
    out = gang(tmp_path, 2, W.gather_rank)
    x = [np.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    w = np.arange(12.0).reshape(6, 2)
    for r in range(2):
        np.testing.assert_array_equal(out[r]["gathered"], np.concatenate(x))
        np.testing.assert_array_equal(out[r]["grad"], (1 + 2) * w[3 * r:3 * r + 3])


# --- B4 with an offset, and the global loss ------------------------------------------


@pytest.mark.parametrize("b,n,d,offset", [(4, 8, 24, 4), (13, 26, 24, 0), (5, 15, 640, 10)])
def test_bbc_rowloss_with_offset_matches_jax_global_formula(b, n, d, offset):
    """B4's plain version over N >= B targets, row i's positive at column
    offset + i: JAX's global branch (`ops/losses.py:128-138`) row by row."""
    g = np.random.default_rng(b + n)
    pred = g.standard_normal((b, d)).astype(np.float32) / np.sqrt(d)
    tar = g.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    s = 100.0 * jnp.dot(jnp.asarray(pred), jnp.asarray(tar).T)
    pos = jnp.take_along_axis(s, (offset + jnp.arange(b))[:, None], axis=-1)[:, 0]
    want = np.asarray(jax.nn.logsumexp(s, axis=-1) - pos)
    got = TL.bbc_rowloss(torch.from_numpy(pred), torch.from_numpy(tar), offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_bbc_offset_zero_over_b_targets_is_the_local_call():
    g = np.random.default_rng(3)
    pred, tar = (torch.from_numpy(g.standard_normal((9, 24)).astype(np.float32))
                 for _ in range(2))
    assert torch.equal(TL.bbc_rowloss(pred, tar, offset=0), TL.bbc_rowloss(pred, tar))
    assert TL.bbc_flops_bytes(9, 24, 9) == TL.bbc_flops_bytes(9, 24)
    assert TL.bbc_flops_bytes(4, 24, 8) == (2 * 4 * 8 * 24, (4 * 24 + 8 * 24 + 4) * 4)
    with pytest.raises(ValueError, match="offset"):
        TL.bbc_rowloss(pred, tar, offset=1)


def test_bbc_mean_loss_with_offset_has_the_plain_gradient():
    """`BBCMeanLoss` (the `_bbc_bwd` backward, delta = softmax - onehot(offset
    + i)) against autograd through the plain version."""
    g = np.random.default_rng(4)
    pred = torch.from_numpy(g.standard_normal((6, 24)).astype(np.float32) / 5)
    tar = torch.from_numpy(g.standard_normal((18, 24)).astype(np.float32) / 5)
    grads = []
    for fn in (lambda p, t: TL.BBCMeanLoss.apply(p, t, 100.0, 6),
               lambda p, t: TL.bbc_rowloss_plain(p, t, 100.0, 6).mean()):
        p, t = pred.clone().requires_grad_(), tar.clone().requires_grad_()
        fn(p, t).backward()
        grads.append((p.grad, t.grad))
    for got, want in zip(*grads):
        _rel(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("b", [1, 64, 512, 1024])
@pytest.mark.parametrize("n_over_b", [1, 2, 8])
def test_bbc_split_plan_over_n_targets_covers_every_tile(b, n_over_b):
    n = b * n_over_b
    splits, per_split = TL.split_plan(b, 132, n)
    tiles = -(-n // 64)
    assert splits == -(-tiles // per_split) and (splits - 1) * per_split < tiles
    assert -(-b // 128) * splits <= max(132, -(-b // 128))


def test_global_loss_and_grads_match_jax_shard_map(tmp_path):
    """negatives="global" on a 2-rank gang against JAX's shard_map over a
    2-device mesh (`tests/test_train.py:570-592`): the mean loss, and
    each rank's gradients, which are size times the gradient of the mean
    (the gathered targets' gradient sums every rank's loss)."""
    g = np.random.default_rng(0)
    pred = g.standard_normal((16, 8)).astype(np.float32)
    tar = g.standard_normal((16, 8)).astype(np.float32)
    fn = jax.shard_map(
        lambda p, t: jax.lax.pmean(JL.batch_based_classification_loss(
            p, t, negatives="global", axis_name="data"), "data"),
        mesh=jmesh.create_mesh(2), in_specs=(P("data", None), P("data", None)),
        out_specs=P())
    want, (gp, gt) = jax.value_and_grad(fn, argnums=(0, 1))(pred, tar)
    out = gang(tmp_path, 2, W.loss_rank, pred, tar)
    plain = float(JL.batch_based_classification_loss(jnp.asarray(pred), jnp.asarray(tar)))
    for r in range(2):
        assert out[r]["loss"] == pytest.approx(float(want), rel=1e-5)
        assert out[r]["loss"] == pytest.approx(plain, rel=1e-5)
    _rel(np.concatenate([o["dpred"] for o in out]) / 2, np.asarray(gp), 1e-5)
    _rel(np.concatenate([o["dtar"] for o in out]) / 2, np.asarray(gt), 1e-5)


# --- the train step ------------------------------------------------------------------


LR = 1e-5
SGD_LR = 2.0 ** 20
# parameters whose exact gradient is zero (tests/test_torch_train.py ZERO_GRAD):
# with BatchNorm on its running statistics the Linear bias ahead of it is not
# one of them
ZERO_GRAD_DET = ("attention.self.key.bias", "embedding_common.bias")


def _zero_grad_mask(name, shape, zero):
    mask = np.zeros(shape, bool)
    if name.endswith(zero):
        mask[...] = True
    elif name.endswith("MR_component.in_proj_bias"):
        mask[shape[0] // 3:2 * shape[0] // 3] = True
    return mask


def _train_batch(seed=0):
    g = np.random.default_rng(seed)
    f = np.float32
    return {"ref_image": g.random((B, 32, 32, 3), dtype=f),
            "tar_image": g.random((B, 32, 32, 3), dtype=f),
            "text_ids": g.integers(1, 100, (B, CTX)).astype(np.int32),
            "ref_patch": g.standard_normal((B, PATCH_NUM, D)).astype(f),
            "tar_patch": g.standard_normal((B, PATCH_NUM, D)).astype(f)}


@functools.cache
def _models(tmp_dir: str):
    jm, variables = jax_model_and_variables(small_config(jax_config))
    path = os.path.join(tmp_dir, "model.pt")
    torch.save(port_model(small_config(torch_config), variables).state_dict(), path)
    return jm, variables, path


def _keep_all_jax(key, p=0.5, shape=None, *args, **kwargs):
    return jnp.ones(() if shape is None else shape, bool)


def _jax_step(jm, variables, negatives, deterministic, opt):
    """One JAX step on the 2-device mesh (shard_map branch) -> (loss, state)."""
    def det_forward(mdl, ref_image, tar_image, text_ids, ref_patch, tar_patch, *,
                    deterministic=False):
        return mdl.train_forward(ref_image, tar_image, text_ids, ref_patch, tar_patch,
                                 deterministic=True)

    mesh = jmesh.create_mesh(2)
    state = jax_create_state(variables, opt, jax.random.PRNGKey(0))
    step = JStep.build_train_step(jm, opt, negatives=negatives, local_groups=2,
                                  forward=det_forward if deterministic else None,
                                  donate=False, mesh=mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _keep_all_jax)
        state2, loss = step(state, jmesh.shard_batch(mesh, _train_batch()))
    return float(loss), state, state2


def _ern(jstate):
    return {k: v.numpy() for k, v in convert.ern_state_dict(
        jstate.ern_params, jstate.batch_stats["ern"]).items()}


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("parallel_train"))


@functools.cache
def _port_step(train_dir, negatives, deterministic, shards, n_ranks):
    jm, variables, path = _models(train_dir)
    out = M.spawn_cpu_gang(n_ranks, W.train_rank, small_config(torch_config), path,
                           _train_batch(), negatives, deterministic, shards, LR,
                           not deterministic, timeout=GANG_TIMEOUT, store_dir=train_dir)
    return out


@pytest.mark.parametrize("negatives", ["local", "global"])
def test_train_step_matches_jax_shard_map(train_dir, negatives):
    """A deterministic forward (BatchNorm on its running statistics, no
    dropout), as `tests/test_train.py:784-813` takes: the 2-rank gang's
    step against JAX `build_train_step(mesh=create_mesh(2))`. The JAX
    gradients come from the same step with SGD at lr 2^20, (before -
    after) / lr: the step then dwarfs the weights, whose rounding would
    swamp a small gradient at lr 1, and the division is exact."""
    jm, variables, _ = _models(train_dir)
    jloss, s0, s1 = _jax_step(jm, variables, negatives, True, optax.sgd(SGD_LR))
    want_grads = {k: (_ern(s0)[k] - v) / SGD_LR for k, v in _ern(s1).items()}
    out = _port_step(train_dir, negatives, True, 1, 2)
    for r in range(2):
        assert out[r]["loss"] == pytest.approx(jloss, rel=2e-5)
        assert out[r]["loss"] == out[0]["loss"]
    grads = out[0]["grads"]
    scale = max(np.abs(want_grads[n]).max() for n in grads)
    for name, got in grads.items():
        want = want_grads[name]
        noise = _zero_grad_mask(name, want.shape, ZERO_GRAD_DET)
        assert np.abs(got[noise]).max(initial=0) < 1e-6 * scale, name
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max() + 1e-6 * scale,
                                   err_msg=name)
        np.testing.assert_array_equal(out[1]["grads"][name], got)
    _, _, adam1 = _jax_step(jm, variables, negatives, True, optax.adam(LR))
    want_params = _ern(adam1)
    for name, got in out[0]["ern"].items():
        np.testing.assert_allclose(got, want_params[name], atol=2e-5, rtol=0, err_msg=name)


def test_train_step_in_train_mode_matches_jax_shard_map(train_dir):
    """The real forward (BatchNorm over each shard's own rows, every
    dropout unit kept on both sides) with global negatives: the loss and
    the BatchNorm running statistics averaged over the shards (JAX's
    `pmean` of `batch_stats`)."""
    jm, variables, _ = _models(train_dir)
    jloss, _, s1 = _jax_step(jm, variables, "global", False, optax.adam(LR))
    out = _port_step(train_dir, "global", False, 1, 2)
    assert out[0]["loss"] == pytest.approx(jloss, rel=2e-5)
    want = _ern(s1)
    keys = [k for k in out[0]["ern"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 8
    for k in keys:
        np.testing.assert_allclose(out[0]["ern"][k], want[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(out[1]["ern"][k], out[0]["ern"][k])


@pytest.mark.parametrize("negatives", ["local", "global"])
def test_one_process_of_two_shards_is_two_ranks(train_dir, negatives):
    """The same 2-shard mesh in two layouts, each shard with its own
    BatchNorm statistics and dropout stream (real masks, folded on the
    shard's index): one process standing for two shards
    (`multiprocess.py one_process_step`) against two ranks."""
    one = M.spawn_cpu_gang(1, W.train_rank, small_config(torch_config),
                           _models(train_dir)[2], _train_batch(), negatives, False, 2, LR,
                           False, timeout=GANG_TIMEOUT, store_dir=train_dir)[0]
    real = M.spawn_cpu_gang(2, W.train_rank, small_config(torch_config),
                            _models(train_dir)[2], _train_batch(), negatives, False, 1, LR,
                            False, timeout=GANG_TIMEOUT, store_dir=train_dir)[0]
    if negatives == "local":   # the same operations on every shard: bit for bit
        assert one["loss"] == real["loss"]
        for name, g in real["grads"].items():
            np.testing.assert_array_equal(one["grads"][name], g, err_msg=name)
        for k, v in real["ern"].items():
            np.testing.assert_array_equal(one["ern"][k], v, err_msg=k)
        return
    # global: one B4 call over both shards' rows against one a rank
    scale = max(np.abs(g).max() for g in real["grads"].values())
    assert one["loss"] == pytest.approx(real["loss"], rel=1e-6)
    for name, g in real["grads"].items():
        np.testing.assert_allclose(one["grads"][name], g, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)
    for k, v in real["ern"].items():   # Adam: lr x sign(g) where g is rounding noise
        np.testing.assert_allclose(one["ern"][k], v, rtol=0, atol=2 * LR, err_msg=k)


@pytest.mark.parametrize("local_groups, raises", [(1, False), (2, False), (3, True)])
def test_local_groups_guard_matches_jax(train_dir, local_groups, raises):
    jm, variables, path = _models(train_dir)
    model = W.load_model(small_config(torch_config), path)
    fake = M.ProcessMesh(object(), 0, 2, torch.device("cpu"))
    opt = optax.adam(LR)
    if raises:
        with pytest.raises(ValueError, match="local_groups must equal the mesh size"):
            TStep.build_train_step(model, lambda s: LR, local_groups=local_groups, mesh=fake)
        with pytest.raises(ValueError, match="local_groups must equal the mesh size"):
            JStep.build_train_step(jm, opt, local_groups=local_groups,
                                   mesh=jmesh.create_mesh(2))
    else:
        TStep.build_train_step(model, lambda s: LR, local_groups=local_groups, mesh=fake)
        JStep.build_train_step(jm, opt, local_groups=local_groups, mesh=jmesh.create_mesh(2))
    # "global" ignores local_groups on both sides
    TStep.build_train_step(model, lambda s: LR, negatives="global", local_groups=3,
                           mesh=fake)


def test_step_generator_folds_the_shard():
    cpu = torch.device("cpu")
    draws = [torch.rand(6, generator=TStep.step_generator(7, 3, cpu, shard)).tolist()
             for shard in (None, 0, 1)]
    assert len({tuple(d) for d in draws}) == 3


# --- sharded search, the mesh API, the sharded serve program --------------------------


@pytest.mark.parametrize("n,k", [(37, 10), (5, 5), (64, 51)])
def test_sharded_search_matches_jax(tmp_path, n, k):
    """A gallery row-sharded over 2 ranks with a padded tail and
    negative-scoring rows (a zero pad row would outrank them unmasked)."""
    g = np.random.default_rng(n)
    gal = g.standard_normal((n, 16)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    q = -gal[:4] + 0.01 * g.standard_normal((4, 16)).astype(np.float32)
    js, ji = JEng.sharded_search(jmesh.create_mesh(2), jnp.asarray(q), jnp.asarray(gal), k=k)
    out = gang(tmp_path, 2, W.search_rank, q, gal, k)
    for s, i in out:
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s, np.asarray(js), atol=1e-5, rtol=0)
    order = np.argsort(-(q @ gal.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(out[0][1], order)


def test_mesh_inference_api_encodes_like_the_unsharded_one(tmp_path):
    """Each rank encodes its slice of every batch (ragged slices padded),
    then an all-gather: every rank holds the unsharded API's outputs."""
    _, variables = jax_model_and_variables(small_config(jax_config))
    path = str(tmp_path / "model.pt")
    torch.save(port_model(small_config(torch_config), variables).state_dict(), path)
    g = np.random.default_rng(5)
    inputs = {"images": g.random((7, 32, 32, 3), dtype=np.float32),
              "ids": g.integers(1, 100, (7, CTX)).astype(np.int32),
              "patches": g.standard_normal((7, PATCH_NUM, D)).astype(np.float32),
              "feats": g.standard_normal((7, D)).astype(np.float32)}
    out = gang(tmp_path, 2, W.api_rank, small_config(torch_config), path, inputs)
    for key, want in out[0]["one"].items():
        assert out[0]["mesh"][key].shape == want.shape, key
        np.testing.assert_allclose(out[0]["mesh"][key], want, atol=2e-5, rtol=0, err_msg=key)
        np.testing.assert_array_equal(out[1]["mesh"][key], out[0]["mesh"][key])


def _tme(cfg):
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tme=True))


SERVE_CASES = {"plain": ({}, False), "quantize_refs": ({"quantize_refs": True}, False),
               "int8_gallery_tme": ({"quantize_gallery": True}, True)}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_sharded_serve_matches_jax_and_the_unsharded_program(tmp_path, case):
    """The gallery-sharded serve program on 2 ranks (11 rows: the last
    shard padded) against JAX's sharded program on the 2-device mesh and
    against the port's single-device program: rows equal, scores within
    1e-5; rank 1 ran both dispatches in lockstep."""
    from test_torch_tme import _with_tme_weights

    flags, tme = SERVE_CASES[case]
    jcfg, tcfg = tiny_config(jax_config), tiny_config(torch_config)
    if tme:
        jcfg, tcfg = _tme(jcfg), _tme(tcfg)
    jm, variables = jax_model_and_variables(jcfg)
    if tme:
        variables = _with_tme_weights(variables)
    path = str(tmp_path / "model.pt")
    torch.save(port_model(tcfg, variables).state_dict(), path)
    g = np.random.default_rng(11)
    n = 11
    gallery = g.standard_normal((n, D)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    arrays = {"gallery": gallery, "ref_f": g.standard_normal((n, D)).astype(np.float32),
              "ref_p": g.standard_normal((n, PATCH_NUM, D)).astype(np.float32)}
    ids = W.crc_tokenizer(["make it red", "longer sleeves", "in blue", "more formal",
                           "darker"])
    rows = np.asarray([3, 0, 10, 7, 5])
    k = 6
    out = gang(tmp_path, 2, W.serve_rank, tcfg, path, arrays, flags, ids, rows, k)
    assert out[1] == {"followed": 2} and out[0]["per"] == 6
    japi = JE.InferenceAPI(jm, variables, batch_size=8, context_length=CTX,
                           tokenizer=W.crc_tokenizer, **flags)
    jfn = japi.build_serve_fn(gallery, k_max=8, buckets=(1, 8), ref_features=arrays["ref_f"],
                              ref_patches=arrays["ref_p"], mesh=jmesh.create_mesh(2))
    for i, m in enumerate((1, len(rows))):
        want_s, want_i = jfn(ids[:m], rows[:m], k=k)
        for got_s, got_i in (out[0]["sharded"][i], out[0]["one"][i]):
            np.testing.assert_array_equal(got_i, np.asarray(want_i))
            np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-5, rtol=0)


# --- the Trainer, the checkpoints, the portability drive, the CLI ---------------------


def test_trainer_resumes_at_another_world_size(tmp_path):
    """A 2-rank Trainer's resume checkpoint restores into a 1-rank Trainer,
    and a 1-rank one's into a 2-rank gang, bit for bit (JAX
    `tests/test_topology.py:151`); each rank loads batch_size rows of the
    global batch, and only rank 0 logs."""
    _, variables = jax_model_and_variables(small_config(jax_config))
    path = str(tmp_path / "model.pt")
    torch.save(port_model(small_config(torch_config), variables).state_dict(), path)
    cfg = small_config(torch_config)
    two_dir = tmp_path / "two"
    out = gang(tmp_path, 2, W.trainer_rank, cfg, path, str(two_dir), None)
    assert out[0]["loader_len"] == 24 // 2 // 4 == out[0]["global_step"]
    for k, v in out[0]["ern"].items():
        np.testing.assert_array_equal(out[1]["ern"][k], v)
    logged = [json.loads(line) for line in open(two_dir / "log.jsonl")]
    assert sum("loss" in r for r in logged) == out[0]["global_step"]    # rank 0 alone

    one = W.make_trainer(cfg, path, str(tmp_path / "one"), resume_path=out[0]["path"])
    assert one.maybe_resume() and one.global_step == out[0]["global_step"]
    for k, v in one.model.ern.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), out[0]["ern"][k])

    solo = W.make_trainer(cfg, path, str(tmp_path / "solo"))
    solo.train()
    saved = solo.save_resume_checkpoint(str(tmp_path / "solo" / "resume"))
    back = gang(tmp_path, 2, W.trainer_rank, cfg, path, str(tmp_path / "back"), saved)
    for r in range(2):
        assert back[r]["restored"] and back[r]["global_step"] == solo.global_step
        for k, v in solo.model.ern.state_dict().items():
            np.testing.assert_array_equal(back[r]["ern"][k], v.numpy())


def test_portability_drive(tmp_path):
    """Legs A (1 rank, 2 shards), CB (2 ranks) and D: c0 == a0, b1 == a1,
    d1 == a1."""
    out = MP.launch_portability_drive(str(tmp_path), timeout=GANG_TIMEOUT)
    assert set(out["deltas"]) == {"gang_step0_matches_control", "restore_1x2_to_2x1",
                                  "restore_2x1_to_1x2"}
    assert all(d <= MP.TOLERANCE for d in out["deltas"].values()), out
    assert np.isfinite(out["control_losses"]).all()
    assert out["control_losses"][0] != out["control_losses"][1]


def test_cpu_simulation():
    out = MP.launch_cpu_simulation(2, timeout=GANG_TIMEOUT)
    assert out["multiprocess_loss"] == pytest.approx(out["single_process_loss"], abs=1e-5)


TINY_CLI = "tiny-parallel"


def _tiny_cli_config():
    return torch_config.CLIPConfig(
        name=TINY_CLI,
        vision=torch_config.VisionConfig(kind="vit", image_size=32, embed_dim=D, width=64,
                                         layers=2, heads=4, patch_size=16),
        text=torch_config.TextConfig(vocab_size=600, context_length=CTX, width=32, heads=4,
                                     layers=2, embed_dim=D))


def test_cli_train_global_negatives_then_eval_data_parallel(tmp_path, monkeypatch):
    """`fashionern-torch train --negatives global` then `eval
    --data-parallel` on a 2-rank gloo gang (as torchrun would launch
    them): the data-parallel eval of the trained checkpoint gives the
    single-process eval's metrics."""
    root = jax_make_fixture(str(tmp_path / "fx"), "fashioniq", dim=D, patch_num=PATCH_NUM,
                            seed=1, n_images=10, n_triplets=8, learnable=True)
    common = ["--dataset", "fashioniq", "--data-root", root, "--clip-model-name", TINY_CLI,
              "--bpe-path", os.path.join(root, "bpe.txt.gz"), "--num-workers", "0",
              "--device", "cpu"]
    ck = str(tmp_path / "ck")
    train = ["train", *common, "--batch-size", "2", "--num-epochs", "1",
             "--validation-frequency", "1", "--validation-bs", "4", "--negatives", "global",
             "--seed", "7", "--ckpt-dir", ck, "--lr", "1e-3"]
    evaluate = ["eval", *common, "--fusion-model-path", os.path.join(ck, "fashioniq-best"),
                "--json", "--data-parallel", "--batch-size", "4"]
    out = gang(tmp_path, 2, W.cli_rank, TINY_CLI, _tiny_cli_config(), train, evaluate)
    assert out[1]["eval"] is None and out[0]["eval"] is not None    # rank 0 prints
    assert os.path.isfile(os.path.join(ck, "fashioniq-resume"))
    monkeypatch.setitem(torch_config._CONFIGS, TINY_CLI, _tiny_cli_config())
    single = cli.run_eval(cli.build_parser().parse_args(evaluate[:-3] + ["--batch-size", "4"]))
    assert out[0]["eval"].keys() == single.keys()
    for key, value in single.items():
        if isinstance(value, dict):
            for sub, v in value.items():
                assert out[0]["eval"][key][sub] == pytest.approx(v, abs=1e-9), (key, sub)
        else:
            assert out[0]["eval"][key] == pytest.approx(value, abs=1e-9), key


def _service_items():
    g = np.random.default_rng(1)
    items = [{"name": f"img{i}", "image": g.random((32, 32, 3), dtype=np.float32),
              "patch": g.standard_normal((PATCH_NUM, D)).astype(np.float32)}
             for i in range(56)]
    return [{k: (np.stack([it[k] for it in items[i:i + 8]]) if k != "name"
                 else [it[k] for it in items[i:i + 8]]) for k in items[0]}
            for i in range(0, 56, 8)]


SERVICE_REFS = ["img3", "img0", "img41"]
SERVICE_CAPS = ["make it red", "longer sleeves", "in blue"]


def _same_answers(got, want):
    for a, b in zip(got, want, strict=True):
        assert [r["name"] for r in a] == [r["name"] for r in b]
        np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                                   atol=1e-5, rtol=0)


def _plain_service(model):
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI
    from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService

    return RetrievalService(InferenceAPI(model, tokenizer=W.crc_tokenizer, device="cpu",
                                         batch_size=8, context_length=CTX), _service_items())


def test_one_process_sharded_service_answers_like_the_plain_one():
    """A RetrievalService over a one-process mesh (identity collectives)
    builds the gallery-sharded program: the same answers as the plain
    service, at a k the program serves and at a k past its k_max (the
    multi-dispatch path)."""
    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import InferenceAPI, ShardedServeFn
    from fashionern_aaai2024_tpu_torch.retrieval.server import RetrievalService

    _, variables = jax_model_and_variables(tiny_config(jax_config))
    model = port_model(tiny_config(torch_config), variables)
    sharded = RetrievalService(InferenceAPI(model, tokenizer=W.crc_tokenizer, device="cpu",
                                            batch_size=8, context_length=CTX,
                                            mesh=M.create_mesh(device="cpu")),
                               _service_items())
    plain = _plain_service(model)
    assert isinstance(sharded._serve_fn, ShardedServeFn)
    for k in (10, sharded._serve_fn.k_max + 3):
        _same_answers(sharded.query(SERVICE_REFS, SERVICE_CAPS, k=k)[0],
                      plain.query(SERVICE_REFS, SERVICE_CAPS, k=k)[0])


def test_two_rank_service_answers_past_k_max_like_the_plain_one(tmp_path):
    """A RetrievalService on a 2-rank gang: rank 0 answers a k the sharded
    program serves and a k past its k_max (the multi-dispatch path, which
    rank 0 runs alone while rank 1 follows) as the plain service does."""
    _, variables = jax_model_and_variables(tiny_config(jax_config))
    model = port_model(tiny_config(torch_config), variables)
    path = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), path)
    ks = [10, 53]
    out = gang(tmp_path, 2, W.service_rank, tiny_config(torch_config), path,
               _service_items(), SERVICE_REFS, SERVICE_CAPS, ks)
    assert out[1] == {"followed": 1} and out[0]["k_max"] < ks[1]
    plain = _plain_service(model)
    for k, got in zip(ks, out[0]["answers"], strict=True):
        assert len(got[0]) == k
        _same_answers(got, plain.query(SERVICE_REFS, SERVICE_CAPS, k=k)[0])


def test_sharded_serve_refuses_gloo_on_the_card(monkeypatch):
    """Each bucket of the serve program on the card is a CUDA graph, which
    cannot hold gloo's collectives: a gloo group there is refused."""
    from types import SimpleNamespace

    from fashionern_aaai2024_tpu_torch.retrieval.evaluate import ShardedServeFn

    monkeypatch.setattr(M.ProcessMesh, "backend", property(lambda self: "gloo"))
    mesh = M.ProcessMesh(object(), 0, 2, torch.device("cuda"))
    with pytest.raises(ValueError, match="needs an NCCL group"):
        ShardedServeFn(SimpleNamespace(device=torch.device("cuda")), mesh,
                       np.zeros((4, D), np.float32), 8, (1,), PATCH_NUM, None, None)
