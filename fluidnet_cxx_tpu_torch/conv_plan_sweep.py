"""Device time of the conv kernels B and N under other settings of their
tile planner (``ops/kernels/conv_plan.py``), on one NVIDIA card:

    python -m fluidnet_cxx_tpu_torch.conv_plan_sweep

For each setting of ``FILL_BLOCKS`` (blocks a layer aims at: one number
for every route, or the planner's own table) and ``WIDE_MIN_TILES`` (when
the wide 64 x bn/2 warp tile is taken; ``off`` never) it prints the
device milliseconds of every layer of the PUNet3 forwards at 128^3
(``PUNet3p8_64`` and ``PUNet3_32`` shapes, bfloat16) and of the 512^2
PUNet forward (``PUNetD2_128`` shapes, float32), each layer on the
activations its forward hands it, 20 calls captured in one CUDA graph and
replayed between CUDA events, and each whole forward the same way.
Weights from seed 0. The planner's defaults come first.
"""
import dataclasses
import time

import torch

from .config import load_model_config
from .ops.kernels import conv_plan, punet, punet3
from .run_plume import MODEL_DIR, build_net
from .run_plume3d import build_punet3

MODELS3 = {"p8": "trained_models/PUNet3p8_64",
           "p4": "trained_models/PUNet3_32"}
DEFAULTS = (dict(conv_plan.FILL_BLOCKS), conv_plan.WIDE_MIN_TILES)
SETTINGS = [DEFAULTS, (128, None), (256, 256), (512, 256), (1024, 256),
            (512, None), (512, 32)]


def graph_ms(fn, reps=20):
    """Device ms of one call: ``reps`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    graph.replay()
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def layer_calls(forward, wrapper):
    """[(name, args)] of each conv of one forward through ``wrapper``."""
    calls = []

    def conv(name, *args):
        calls.append((name, args))
        return wrapper(*args)

    forward(conv)
    return calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("conv_plan_sweep needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x3 = torch.stack([torch.randn((1, 128, 128, 128), generator=gen),
                      (torch.rand((1, 128, 128, 128), generator=gen)
                       < 0.08).float()], dim=-1).to(dev)
    x2 = torch.stack([torch.randn((1, 512, 512), generator=gen),
                      (torch.rand((1, 512, 512), generator=gen)
                       < 0.1).float()], dim=-1).to(dev)
    inv = torch.tensor([3.0], device=dev)
    nets = {}
    for label, model_dir in MODELS3.items():
        cfg = dataclasses.replace(load_model_config(model_dir),
                                  compute_dtype="bfloat16")
        net = build_punet3(cfg, 0, dev)
        nets[label] = (net, punet3.pack_weights3(net))
    net2 = build_net(load_model_config(str(MODEL_DIR)), 0, dev)
    with torch.no_grad():
        packed2 = punet.pack_weights(net2)

    def forward3(net, packed):
        def run(hook):
            def conv(name, h, x2=None, relu=True):
                w, b = packed[name]
                return hook(name, h, w, b, net.strides[name], relu, x2,
                            net.out_dtype(relu))
            return net(x3, conv=conv)
        return run

    def forward2(hook):
        def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
            w, b = packed2[name]
            _, stride, dil = net2.geometry[name]
            return hook(name, h, w, b, stride, dil, relu, x2, in_scale,
                        scale_mod)
        return net2(x2, inv_scale=inv, conv=conv)

    print(torch.cuda.get_device_name(0), flush=True)
    with torch.no_grad():
        for fill, wide in SETTINGS:
            conv_plan.FILL_BLOCKS = (fill if isinstance(fill, dict) else
                                     dict.fromkeys(DEFAULTS[0], fill))
            conv_plan.WIDE_MIN_TILES = wide or 1 << 30
            conv_plan.plan_conv.cache_clear()
            t0 = time.perf_counter()
            print(f"FILL_BLOCKS {fill}, WIDE_MIN_TILES {wide or 'off'}:",
                  flush=True)
            cases = [(f"N {label}", forward3(*nets[label]),
                      punet3.conv3d_ndhwc,
                      lambda n=nets[label]: punet3.punet3_forward(*n, x3))
                     for label in MODELS3]
            cases.append(("B 512^2", forward2, punet.conv2d_nhwc,
                          lambda: punet.net_forward(net2, packed2, x2,
                                                    inv_scale=inv)))
            for label, forward, wrapper, whole in cases:
                layers = {name: graph_ms(lambda a=args: wrapper(*a))
                          for name, args in layer_calls(forward, wrapper)}
                print(f"  {label}: forward {graph_ms(whole, 5):.4f} ms, "
                      f"layers {sum(layers.values()):.4f}: "
                      + " ".join(f"{k} {v:.4f}" for k, v in layers.items()),
                      flush=True)
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
