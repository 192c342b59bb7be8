"""objectdetection_ssd_torch — the PyTorch/CUDA port of
`objectdetection_ssd_tpu`, for NVIDIA Hopper (H100).

It imports no JAX and nothing of the JAX package; the JAX package stays the
reference that the tests hold this one against.  Ported so far: the SSD300
serving path (priors, box ops, the VGG16 SSD300 model, postprocess with a
hand-written CUDA greedy-NMS kernel, `infer.detector.Detector`) and the
SSD300 train step (matching, the multibox loss, SGD, `train.loop.train_step`
with a hand-written CUDA filter-gradient kernel for the routed 3x3 convs).

Quick start (on a CUDA card):
    from objectdetection_ssd_torch.config import Config
    from objectdetection_ssd_torch.infer.detector import Detector
    det = Detector(Config(), state_dict)          # device defaults to cuda
    dets = det.detect_batch(uint8_images_nhwc)
"""
