"""The port's pipelined cascade server, cascade-stage training and the
multi-host helpers on the CPU, over gloo groups of 2 processes (one per
stage) and 4 (two per stage), joined through torchrun's and the JAX
package's environment variables: ``CascadePipelineServer`` against
``Imagen.sample`` at the same generator (DDIM, per-stage step budgets with
a truncated super-res stage, DDPM's per-step draws), in request order; the
cascade trainer against the one-device stage step (clip-50 SGD, element by
element); and the environment rendezvous of torchrun and of the JAX
package (``multihost``)."""
import socket

import numpy as np
import pytest
import torch_mesh_workers as W

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs():
    """Both groups at once, each joined through the environment: world 2
    as torchrun sets it, world 4 as the JAX package's multi-host variables
    do; each runs the pipeline and the multi-host scenarios."""
    torchrun = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    coordinator = f"localhost:{_free_port()}"
    jax_style = [{"COORDINATOR_ADDRESS": coordinator, "NUM_PROCESSES": "4",
                  "PROCESS_ID": str(r)} for r in range(4)]
    spec = {"run": ["pipeline_scenarios", "multihost_scenarios"]}
    out = W.start({2: ("torch_mesh_workers:scenarios", 2, spec,
                       dict(rendezvous="env", env=torchrun)),
                   4: ("torch_mesh_workers:scenarios", 4, spec,
                       dict(rendezvous="env", env=jax_style))})()
    return {w: [r["pipeline_scenarios"] for r in out[w]] for w in WORLDS} | {
        "multihost": {w: [r["multihost_scenarios"] for r in out[w]] for w in WORLDS}}


def _last_group(runs, world):
    return [r for r in runs[world] if r["stage"] == 1]


@pytest.mark.parametrize("world", WORLDS)
def test_stage_groups_split_the_world(runs, world):
    groups = runs[world][0]["groups"]
    assert groups == [list(range(world // 2)), list(range(world // 2, world))]
    assert [r["stage"] for r in runs[world]] == [0] * (world // 2) + [1] * (world // 2)


@pytest.mark.parametrize("name", ["ddim", "budgets", "ddpm"])
@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_sequential_sample(runs, world, name):
    for r in _last_group(runs, world):
        assert len(r[name]) == len(r[name + "_ref"])
        for got, ref in zip(r[name], r[name + "_ref"]):
            assert got.shape == ref.shape == (4, 16, 16, 3)
            if world == 2:  # one process per stage: the same arithmetic as sample
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_serve_streams_in_order(runs, world):
    for r in runs[world]:
        if r["stage"] == 0:
            assert r["ddim"] == [None, None, None]
    outs = _last_group(runs, world)[0]["ddim"]
    # three requests with three seeds: three different images, in order
    assert len(outs) == 3 and not np.allclose(outs[0], outs[1])


@pytest.mark.parametrize("world", WORLDS)
def test_cascade_trainer_matches_the_one_device_stage_step(runs, world):
    for r in runs[world]:
        t = r["trainer"]
        assert t["keys"] == [f"unet_{r['stage']}"]
        np.testing.assert_allclose(t["losses"][:, r["stage"]], t["ref_losses"], rtol=2e-4)
        assert np.all(np.isfinite(t["losses"])) and np.all(t["losses"] > 0)
        np.testing.assert_allclose(t["params"], t["ref_params"], rtol=2e-4, atol=1e-6)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", WORLDS, ids=["torchrun-env", "jax-env"])
def test_multihost_rendezvous_and_global_batches(runs, world):
    ranks = runs["multihost"][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks:
        assert r["shape"] == {"data": world, "model": 1} and r["initialized"] is True
        assert r["same"] is True
        assert "local batches differ" in r["uneven"]
