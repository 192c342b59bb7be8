"""Spatial partitioning of the port at ``spatial`` = 4 on the CPU over four
gloo ranks (`tests/test_torch_sp.py` has ``spatial`` = 2 and JAX): the
uneven splits that 300 and 224 px give (SSD300's 75, 38, 19, 10, 5, 3
and 1 rows; ResNet-34's 7, 4, 2 and 1), where ranks own no rows of the
small maps and halos reach past the neighbour (fc6's dilation 4, the
3x3 VALID extras at 5 -> 3 -> 1), against the port's single-process runs.

* The halo exchange and the row gather, forward and backward, for every
  conv and pool geometry of both families: to 1e-5 of the unsplit layer's
  largest output and gradient.
* One ResNet-34 step in train mode (224 px, f32, batch 2, frozen trunk,
  the neck's and heads' BatchNorms on batch statistics over every rank,
  dropout 0.4 from masks drawn at the global shape): losses and BN
  statistics to 1e-5, gradients to 5e-4 of their largest (the gate of
  the ResNet-34 train-mode outputs, `ROADMAP.md` §3).
* `Detector(mesh=)` on seeded wide-bias SSD300 weights: f32 detections of
  one image to rtol 1e-5 / atol 1e-6; int8 (chained): every K3 call's
  output bit-equal to the rows of the single-process call that the rank
  computed (a rank without rows computes one and discards it),
  detections equal.
"""

import numpy as np
import pytest
import torch

from objectdetection_ssd_torch.config import Config
from objectdetection_ssd_torch.infer.detector import Detector
from tests.test_torch_sp import assert_layers
from tests.test_torch_tp import assert_detections, assert_int8_calls
from tests.tp_sp_ranks import (GEOMETRIES, images, int8_reference, rank_sp,
                               resnet_batch, resnet_step, resnet_weights,
                               run_ranks, wide_bias_state_dict)

torch.set_num_threads(2)

WAYS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp4")
    resnet_sd, resnet_path = resnet_weights(tmp)
    det_sd = wide_bias_state_dict()
    det_weights = str(tmp / "det.pt")
    torch.save(det_sd, det_weights)
    qtree_path, single = int8_reference(det_sd, tmp)
    out = str(tmp / "out")
    run_ranks(rank_sp, WAYS, tmp, resnet_path, det_weights, qtree_path,
              single, out, threads=1)
    ranks = [torch.load(f"{out}.{r}", weights_only=False)
             for r in range(WAYS)]
    return dict(ranks=ranks, resnet_sd=resnet_sd, det_sd=det_sd,
                single=single)


@pytest.mark.parametrize("geometry", [g[0] for g in GEOMETRIES])
def test_halo_exchange_forward_and_backward_uneven(world, geometry):
    assert_layers(world["ranks"], geometry)


def test_resnet34_train_mode_step_uneven(world):
    smetrics, sgrads, sstats = resnet_step(world["resnet_sd"],
                                           resnet_batch())
    for rank in world["ranks"]:
        metrics, grads, stats = rank["resnet"]
        assert metrics["num_pos"] == smetrics["num_pos"] > 0
        for k in ("loss", "cls_loss", "loc_loss"):
            np.testing.assert_allclose(metrics[k], smetrics[k], rtol=1e-5,
                                       err_msg=k)
        assert set(grads) == set(sgrads)
        for name, g in sgrads.items():
            g = g.numpy()
            if name.startswith("loc_") and name.endswith("conv.bias"):
                # Zero in exact arithmetic (a BN follows the conv).
                assert np.abs(g).max() < 1e-7, name
                assert grads[name].abs().max() < 1e-7, name
                continue
            np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                       atol=5e-4 * np.abs(g).max(),
                                       err_msg=name)
        for name, s in sstats.items():
            np.testing.assert_allclose(stats[name].numpy(), s.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_detect_batch_uneven_matches_single_process(world):
    single = Detector(Config(), world["det_sd"],
                      device="cpu").detect_batch(images())
    assert single.valid.sum() > 0
    for rank in world["ranks"]:
        assert_detections(rank["detector"]["f32"], single, 1e-5, 1e-6)


def test_int8_calls_uneven_bit_equal_to_single_process(world):
    assert_int8_calls(world["ranks"], world["single"])
