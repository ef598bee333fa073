"""Quickstart on the PyTorch port: the full user journey in one script.

  1. train the flagship SCAT model a few steps on the in-memory
     synthetic dataset (no downloads needed),
  2. evaluate it (PA-MPJPE / AUC / PCK, the reference's protocol),
  3. export the trained weights as a reference-keyed ``hand_net.pth``
     that the original torch code loads unchanged,
  4. reload that .pth back through the eval path.

Runs on the CUDA device (224-px crops, the hand-written attention
kernels):
  python examples/quickstart_torch.py
or on the CPU when asked (64-px crops, the plain attention):
  python examples/quickstart_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch


def main(device=None):
    """Run the journey on ``device`` (default ``cuda``; raises where CUDA
    is absent unless ``device="cpu"``).  Returns what it printed: the
    logged losses by step, both evaluations, the .pth path and the
    held-out batches."""
    from scat_tpu_torch.config import BaseOptions
    from scat_tpu_torch.convert import state_dict_for_net
    from scat_tpu_torch.data.synthetic import synth_batch
    from scat_tpu_torch.devices import resolve_device
    from scat_tpu_torch.evaluation.evaluator import Evaluator
    from scat_tpu_torch.models import build_model
    from scat_tpu_torch.models.factory import compute_dtype
    from scat_tpu_torch.parallel import mesh as mesh_lib
    from scat_tpu_torch.training import schedule, steps
    from scat_tpu_torch.training.state import TrainState
    from scat_tpu_torch.utils import checkpoint

    device = resolve_device(device, "quickstart_torch")
    on_cpu = device.type == "cpu"
    img = 64 if on_cpu else 224
    opt = BaseOptions().parse(
        ("--net reg_transformer --vit_heads 2 --iteration 1 "
         "--batch_size 8 --mask_rate 0.2 --l_weight_3d 100000 "
         "--l_weight_2d 10 --compute_dtype float32 "
         "--use_pallas_attention " + str(not on_cpu)).split())

    def batch(seed):
        gen = torch.Generator(device).manual_seed(seed)
        return synth_batch(gen, opt.batch_size, img, mean)

    # 1. train
    model, mean = build_model(opt, image_size=img)
    checkpoint.init_weights(model, seed=0)
    model = model.to(device, memory_format=torch.channels_last)
    model.set_compute_dtype(compute_dtype(opt))
    optimizer, scheduler = schedule.make_optimizer(model, opt.lr,
                                                   steps_per_epoch=8)
    state = TrainState.create(model, optimizer, scheduler, seed=2)
    # no process group (a plain `python` run): no mesh, one device
    mesh = mesh_lib.make_mesh(device_type=device.type)
    if mesh is not None:
        state.wrapped = mesh_lib.replicate_state(mesh, model)
        state.mesh = mesh
    step = steps.make_train_step(opt.l_weight_3d, opt.l_weight_2d,
                                 mesh=mesh)
    losses = {}
    for i in range(24):
        stats = step(state, mesh_lib.shard_batch(mesh, batch(10 + i)))
        if i % 8 == 0:
            losses[i] = float(stats["loss"])
            print(f"step {i:3d}  loss {losses[i]:12.1f}")

    # 2. evaluate on held-out synthetic batches
    held_out = [batch(999 + i) for i in range(2)]
    ev = Evaluator(opt, image_size=img, dataset=held_out,
                   state_dict=model.state_dict(), device=device)
    res = ev.eval()

    # 3. export for the torch reference
    sd = state_dict_for_net(opt.net, model)
    pth = os.path.join(opt.result_dir, "hand_net.pth")
    os.makedirs(opt.result_dir, exist_ok=True)
    torch.save(sd, pth)
    print(f"exported {len(sd)} tensors -> {pth}")

    # 4. and reload it through the .pth eval path
    opt2 = BaseOptions().parse(
        ["--net", "reg_transformer", "--vit_heads", "2",
         "--iteration", "1", "--batch_size", "8",
         "--compute_dtype", "float32", "--use_pallas_attention",
         "False", "--result_dir", opt.result_dir,
         "--checkpoint_path_eval", pth])
    ev2 = Evaluator(opt2, image_size=img, dataset=held_out, device=device)
    res2 = ev2.eval()
    assert abs(res2["mpjpe_mm"] - res["mpjpe_mm"]) < 1e-3
    print("reloaded .pth reproduces the evaluation exactly")
    print(f"done: PA-MPJPE {res['mpjpe_mm']:.2f} mm, "
          f"AUC {res['auc']:.1f}")
    return {"losses": losses, "eval": res, "reload": res2, "pth": pth,
            "held_out": held_out}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(ap.parse_args().device)
