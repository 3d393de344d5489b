"""The port's parameter server, dist-mnist worker, RunConfig and estimator
against the JAX package's.

* `shard_names`, `flatten_params` and `unflatten_params` give the JAX
  package's names and trees;
* a dist-mnist worker's gradient (the port's `grad_fn` on the flax-named
  wire arrays) against the JAX workload's `grad_fn` (value_and_grad of the
  mean NLL): 1e-5 relative Frobenius per leaf, loss 1e-6 relative;
* wire interop, both ways, on both transports: a port client against the
  JAX package's `ParameterServer` / `NativeParameterServer` and a JAX
  client against the port's; the pulled arrays are the served ones and the
  values after a push are the shard's downpour update, bit for bit;
* `runconfig_from_env` returns the JAX package's dict for every TF_CONFIG
  case;
* a port estimator's checkpoint is found by the JAX estimator's
  `_latest_checkpoint` and unflattens to the flax tree;
* the native library builds from `native/ps_server.cpp` into
  `tf_operator_tpu_torch/ops/_build/` only;
* the workloads' exits: dist_mnist without a topology, without PS replicas
  and with `--transport native` but no library (2); every small workload
  without CUDA and without TPUJOB_FORCE_PLATFORM=cpu (non-zero).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.mnist import MnistMLP as JMnistMLP
from tf_operator_tpu.train import native_ps as j_native_ps
from tf_operator_tpu.train import ps as j_ps
from tf_operator_tpu.workloads import estimator as j_estimator
from tf_operator_tpu.workloads.runner import \
    runconfig_from_env as j_runconfig_from_env
from tf_operator_tpu_torch.models.mnist import MnistMLP
from tf_operator_tpu_torch.train import native_build, native_ps, ps
from tf_operator_tpu_torch.train.data import synthetic_mnist
from tf_operator_tpu_torch.workloads import dist_mnist, estimator
from tf_operator_tpu_torch.workloads.runner import runconfig_from_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRAD_RTOL = 1e-5
LR = 0.1  # dist_mnist's default


@pytest.fixture(scope="module")
def flax_params():
    params = JMnistMLP().init(jax.random.PRNGKey(0),
                              jnp.zeros((2, 784)))["params"]
    return jax.device_get(params)


def test_shard_names_and_flatten_params_are_jaxs(flax_params):
    flat, j_flat = ps.flatten_params(flax_params), \
        j_ps.flatten_params(flax_params)
    assert list(flat) == list(j_flat)
    for name in flat:
        assert flat[name].dtype == j_flat[name].dtype == np.float32
        assert np.array_equal(flat[name], j_flat[name])
    names = list(flat) + ["a/b", "z", "m/kernel"]
    for num_ps in (1, 2, 3):
        for i in range(num_ps):
            assert ps.shard_names(names, num_ps, i) == \
                j_ps.shard_names(names, num_ps, i)
    back, j_back = ps.unflatten_params(flat), j_ps.unflatten_params(flat)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(j_back)


def test_dist_mnist_gradient_matches_jax(flax_params):
    """The port worker's step on the wire's arrays (flattened to 1-D, as
    the native transport carries them) against the JAX workload's grad_fn
    on the same tree and batch."""
    batch = next(synthetic_mnist(64, seed=100))
    model = JMnistMLP()

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["x"]))
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(batch["label"])[:, None], -1))

    want_loss, want = jax.value_and_grad(loss_fn)(flax_params)
    want = j_ps.flatten_params(jax.device_get(want))
    template = ps.flatten_params(flax_params)
    wire = {n: a.ravel() for n, a in template.items()}
    loss, got = dist_mnist.grad_fn(MnistMLP(), wire, template,
                                   torch.from_numpy(batch["x"]),
                                   torch.from_numpy(batch["label"]))
    assert abs(float(loss) - float(want_loss)) <= 1e-6 * float(want_loss)
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert got[name].shape == g.shape and got[name].dtype == np.float32
        err = np.linalg.norm(got[name] - g) / np.linalg.norm(g)
        assert err <= GRAD_RTOL, (name, err)


def _server(package, transport, params):
    if transport == "python":
        cls = ps.ParameterServer if package == "port" else \
            j_ps.ParameterServer
        server = cls(("127.0.0.1", 0), params, lr=LR)
        import threading

        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, server.server_address[1]
    cls = native_ps.NativeParameterServer if package == "port" else \
        j_native_ps.NativeParameterServer
    server = cls(("127.0.0.1", 0), params, lr=LR)
    return server, server.port


def _client(package, transport, addresses):
    if transport == "python":
        cls = ps.PSClient if package == "port" else j_ps.PSClient
    else:
        cls = native_ps.NativePSClient if package == "port" else \
            j_native_ps.NativePSClient
    return cls(addresses)


def _close(server, transport):
    if transport == "python":
        server.shutdown()
        server.server_close()
    else:
        server.close()


@pytest.mark.parametrize("transport", ["python", "native"])
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_wire_interop(flax_params, transport, client_pkg, server_pkg):
    """Two shards of the MLP (round-robin by sorted name), served by one
    package and pulled and pushed by the other's client: the pulled arrays
    are the served values, and after one push each is value - lr * grad
    in f32, bit for bit (the numpy and the C++ update round alike)."""
    flat = ps.flatten_params(flax_params)
    servers = [_server(server_pkg, transport,
                       {n: flat[n] for n in ps.shard_names(list(flat), 2, i)})
               for i in range(2)]
    try:
        client = _client(client_pkg, transport,
                         [f"127.0.0.1:{port}" for _, port in servers])
        pulled = client.pull()
        assert sorted(pulled) == sorted(flat)
        for name, value in pulled.items():
            assert np.array_equal(np.asarray(value).reshape(flat[name].shape),
                                  flat[name])
        rng = np.random.RandomState(0)
        grads = {n: rng.randn(*a.shape).astype(np.float32)
                 for n, a in flat.items()}
        client.push(grads)
        after = client.pull()
        for name, value in after.items():
            want = flat[name] - np.float32(LR) * grads[name]
            assert np.array_equal(np.asarray(value).reshape(want.shape),
                                  want), name
        client.close()
    finally:
        for server, _ in servers:
            _close(server, transport)


def test_native_library_builds_into_the_ports_build_dir():
    assert native_ps.native_ps_available()
    lib = native_build.target(native_ps.SOURCE, "tpujob_ps")
    assert lib.exists()
    assert lib.parent == REPO / "tf_operator_tpu_torch" / "ops" / "_build"
    assert native_ps.SOURCE == REPO / "native" / "ps_server.cpp"


CLUSTER = {"chief": ["c0:2222"], "worker": ["w0:2222", "w1:2222"],
           "ps": ["p0:2222", "p1:2222"], "evaluator": ["e0:2222"]}
SPARSE = {"worker": {"1": "w1:2222"}, "ps": ["p0:2222", "p1:2222"]}
RUNCONFIG_CASES = {
    "none": None,
    "chief": {"cluster": CLUSTER, "task": {"type": "chief", "index": 0}},
    "master": {"cluster": {"master": ["m0:2222"], "worker": ["w0:2222"]},
               "task": {"type": "master", "index": 0}},
    "worker": {"cluster": CLUSTER, "task": {"type": "worker", "index": 1}},
    "ps": {"cluster": CLUSTER, "task": {"type": "ps", "index": 1}},
    "evaluator": {"cluster": CLUSTER,
                  "task": {"type": "evaluator", "index": 0}},
    "worker_out_of_range": {"cluster": CLUSTER,
                            "task": {"type": "worker", "index": 5}},
    "sparse_worker": {"sparseCluster": SPARSE,
                      "task": {"type": "worker", "index": 1}},
    "sparse_ps": {"sparseCluster": SPARSE, "task": {"type": "ps",
                                                     "index": 0}},
    "sparse_chief": {"sparseCluster": SPARSE,
                     "task": {"type": "chief", "index": 0}},
}


@pytest.mark.parametrize("case", sorted(RUNCONFIG_CASES))
def test_runconfig_from_env_is_jaxs(case):
    cfg = RUNCONFIG_CASES[case]
    env = {} if cfg is None else {"TF_CONFIG": json.dumps(cfg)}
    assert runconfig_from_env(env) == j_runconfig_from_env(env)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("TPUJOB_FORCE_PLATFORM", "cpu")
    for key in ("TF_CONFIG", "TPUJOB_REPLICA_TYPE", "TPUJOB_REPLICA_INDEX",
                "TPUJOB_PROCESS_ID", "TPUJOB_NUM_PROCESSES",
                "TPUJOB_PS_TRANSPORT"):
        monkeypatch.delenv(key, raising=False)


def test_estimator_checkpoint_read_by_the_jax_estimator(on_cpu, tmp_path,
                                                       capsys, flax_params):
    """A local-mode chief (no TF_CONFIG) of the port writes ckpt-<step>.npz
    files that the JAX estimator's `_latest_checkpoint` finds and whose
    arrays unflatten to the flax tree, which the flax model applies."""
    model_dir = str(tmp_path / "model")
    assert estimator.main(["--steps", "5", "--checkpoint-every", "2",
                           "--model-dir", model_dir]) == 0
    out = capsys.readouterr().out
    assert '"task_type": "worker"' in out and '"is_chief": true' in out
    assert "chief: published DONE" in out
    step, path = j_estimator._latest_checkpoint(model_dir)
    assert step == 5 and path.endswith("ckpt-5.npz")
    assert sorted(os.listdir(model_dir)) == [
        "DONE", "ckpt-2.npz", "ckpt-4.npz", "ckpt-5.npz"]
    with np.load(path) as z:
        tree = j_ps.unflatten_params({k: z[k] for k in z.files})
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(flax_params)
    for got, want in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(flax_params)):
        assert got.shape == want.shape and got.dtype == np.float32
    x = next(synthetic_mnist(4, seed=0))["x"]
    assert np.isfinite(np.asarray(JMnistMLP().apply({"params": tree},
                                                    x))).all()


@pytest.mark.parametrize("tf_config,message", [
    (None, "dist_mnist requires a distributed TF_CONFIG topology"),
    ({"cluster": {"worker": ["w0:1"]}, "task": {"type": "worker",
                                                "index": 0}},
     "no PS replicas in cluster spec"),
])
def test_dist_mnist_refuses_a_topology_without_ps(on_cpu, monkeypatch,
                                                  capsys, tf_config,
                                                  message):
    if tf_config is not None:
        monkeypatch.setenv("TF_CONFIG", json.dumps(tf_config))
    assert dist_mnist.main(["--steps", "1"]) == 2
    assert message in capsys.readouterr().out


def test_dist_mnist_native_without_library_exits_2(on_cpu, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("TF_CONFIG", json.dumps(
        {"cluster": {"ps": ["127.0.0.1:1"], "worker": ["w0:1"]},
         "task": {"type": "ps", "index": 0}}))
    monkeypatch.setattr(native_ps, "native_ps_available", lambda: False)
    assert dist_mnist.main(["--transport", "native"]) == 2
    assert "refusing to fall back" in capsys.readouterr().out


SMALL_WORKLOADS = ["mnist", "dist_mnist", "estimator", "smoke",
                   "allreduce_check", "multislice_check"]


@pytest.mark.parametrize("name", SMALL_WORKLOADS)
def test_exits_nonzero_without_cuda_or_cpu_knob(name, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUJOB_", "TF_CONFIG", "MEGASCALE_"))}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    args = ["--model-dir", str(tmp_path)] if name == "estimator" else []
    proc = subprocess.run(
        [sys.executable, "-m", f"tf_operator_tpu_torch.workloads.{name}"]
        + args, cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "TPUJOB_FORCE_PLATFORM=cpu" in proc.stdout
