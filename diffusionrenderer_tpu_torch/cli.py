"""Command-line interface (counterpart of diffusionrenderer_tpu/cli.py), the
port's user-facing surface beside the ComfyUI nodes.

    python -m diffusionrenderer_tpu_torch.cli inverse  --input rgb.png --output-dir out/
    python -m diffusionrenderer_tpu_torch.cli forward  --depth d.png --normal n.png \\
        --roughness r.png --metallic m.png --basecolor b.png --env sky.hdr \\
        --output relit.png
    python -m diffusionrenderer_tpu_torch.cli envmap   --input sky.hdr --height 704 \\
        --width 1280 --output-prefix env
    python -m diffusionrenderer_tpu_torch.cli info

Every command runs on the CUDA card, and raises without one, unless --cpu
(given before the command) asks for the CPU.  Without --checkpoint the model
is random-initialized from fixed seeds (a plumbing smoke test); real runs
pass the reference checkpoints or the native files `convert` writes.
PNG frames are read and written by the port's own codec (io.read_png /
io.write_png); other LDR formats need imageio.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import torch

from .io import load_image, load_video, save_frames
from .utils.device import resolve_device


def _tiny_configs(model_type: str):
    """Smoke-test mode: scaled-down architecture (random weights unless a
    matching tiny checkpoint is passed)."""
    from .config import DiTConfig, VAEConfig

    net_config = DiTConfig(
        model_channels=48, num_blocks=2, num_heads=2, adaln_lora_dim=8,
        crossattn_emb_channels=16,
        additional_concat_ch=16 if model_type == "inverse" else 17 * 8,
        use_context_embedding=model_type == "inverse",
    )
    vae_config = VAEConfig(
        encoder_block_out_channels=(8, 12, 16, 16),
        decode_block_out_channels=(12, 16, 16, 16), num_layers=1,
    )
    return net_config, vae_config


def _device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else None)


def _keep_bf16(args) -> tuple:
    return tuple(args.quant_keep_bf16.split(",")) if args.quant_keep_bf16 else ()


def _build_pipeline(args, model_type: str):
    from .api import load_pipeline

    net_config = vae_config = None
    compute_dtype = "bfloat16"
    if args.tiny:
        net_config, vae_config = _tiny_configs(model_type)
        compute_dtype = "float32"
    return load_pipeline(
        dit_checkpoint=args.checkpoint,
        vae_checkpoint=args.vae,
        model_type=model_type,
        guidance=args.guidance,
        num_steps=args.steps,
        seed=args.seed,
        quantize_int8=args.int8 or args.w8a8,
        act_quant=args.w8a8,
        quant_group_size=args.quant_group,
        quant_keep_bf16=_keep_bf16(args),
        net_config=net_config,
        vae_config=vae_config,
        compute_dtype=compute_dtype,
        dtype=torch.float32 if args.tiny else torch.bfloat16,
        device=_device(args),
    )


def cmd_inverse(args) -> None:
    from .api import inverse_render

    video = load_video(args.input)
    pipe = _build_pipeline(args, "inverse")
    passes = tuple(args.passes.split(","))
    out = inverse_render(pipe, video, guidance=args.guidance, seed=args.seed,
                         passes=passes, resume_dir=args.resume_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    for name, frames in out.items():
        save_frames(frames, os.path.join(args.output_dir, f"{name}.png"))


def cmd_forward(args) -> None:
    from .api import forward_render

    pipe = _build_pipeline(args, "forward")
    out = forward_render(
        pipe,
        depth=load_video(args.depth),
        normal=load_video(args.normal),
        roughness=load_video(args.roughness),
        metallic=load_video(args.metallic),
        base_color=load_video(args.basecolor),
        env_map=load_image(args.env),
        guidance=args.guidance,
        seed=args.seed,
        env_format=args.env_format,
        env_brightness=args.env_brightness,
        env_flip_horizontal=args.env_flip,
        env_rotation=args.env_rotation,
    )
    save_frames(out, args.output)


def cmd_envmap(args) -> None:
    from .envmap import render_projection_from_panorama

    env = render_projection_from_panorama(
        load_image(args.input),
        resolution=(args.height, args.width),
        env_brightness=args.env_brightness,
        env_flip=args.env_flip,
        env_rot=args.env_rotation,
        mode="direct" if args.direct else "cubemap",
        device=_device(args),
    )
    for name in ("env_ldr", "env_log"):
        save_frames(env[name].cpu().numpy(), f"{args.output_prefix}_{name}.png")


def cmd_convert(args) -> None:
    """Convert reference checkpoints to the port's native flat files.

    Convert once at deployment time; every later load_pipeline restores the
    native tree directly: no key mapping, no quantization at start-up.
    Quantization is baked into the saved tree (the int8 'q' and scale leaves
    describe themselves on restore).  The JAX package's orbax directories
    do not apply on CUDA."""
    from .checkpoint import load_dit_checkpoint, save_native
    from .checkpoint_vae import calibrate_vae_conventions, load_vae_checkpoint, save_vae_native
    from .config import DiTConfig, VAEConfig

    if not args.dit and not args.vae:
        raise SystemExit("convert: pass --dit and/or --vae")
    device = _device(args)
    os.makedirs(args.out, exist_ok=True)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    if args.dit:
        if args.tiny:
            cfg, _ = _tiny_configs(args.model_type)
        elif args.model_type == "inverse":
            cfg = DiTConfig(additional_concat_ch=16, use_context_embedding=True)
        else:
            cfg = DiTConfig(additional_concat_ch=17 * 8, use_context_embedding=False)
        params = load_dit_checkpoint(
            args.dit, cfg, dtype,
            quantize_int8=args.int8 or args.w8a8, act_quant=args.w8a8,
            group_size=args.quant_group, keep_bf16=_keep_bf16(args), device=device,
        )
        out = os.path.join(args.out, "dit")
        save_native(out, params)
        print(f"wrote {out}")
    if args.vae:
        vcfg = _tiny_configs(args.model_type)[1] if args.tiny else VAEConfig()
        vae_params = load_vae_checkpoint(args.vae, vcfg, dtype, device=device)
        if not args.tiny and not args.skip_calibration:
            # Constant-frame round trip: catches a wrong DWT-rescale or
            # statistics convention against the trained weights at convert
            # time instead of silently shifting every output.
            errs = calibrate_vae_conventions(vae_params, vcfg)
            print(f"calibration OK (constant-frame roundtrip errors: {errs})")
        out = os.path.join(args.out, "vae")
        save_vae_native(out, vae_params)
        print(f"wrote {out}")
    # Sidecar: load_pipeline reads it to fail fast on a model-type mismatch.
    # model_type describes the DiT only (the VAE is model-agnostic), so a
    # --vae-only convert does not stamp it, and a second convert into the
    # same --out merges rather than overwrites, refusing on a conflict.
    meta = {"tiny": bool(args.tiny)}
    if args.dit:
        meta["model_type"] = args.model_type
        quant = "w8a8" if args.w8a8 else ("w8" if args.int8 else None)
        if quant and args.quant_group:
            quant += f"_g{args.quant_group}"
        if quant and args.quant_keep_bf16:
            quant += f"_keep[{args.quant_keep_bf16}]"
        meta["quant"] = quant
    meta_path = os.path.join(args.out, "convert_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            prior = json.load(f)
        conflicts = {
            k: (prior[k], meta[k])
            for k in meta
            if k in prior and prior[k] is not None and prior[k] != meta[k]
        }
        if conflicts:
            raise SystemExit(
                f"convert: {meta_path} already records "
                + ", ".join(f"{k}={old!r} (requested {new!r})"
                            for k, (old, new) in conflicts.items())
                + " — converting a different model into the same --out "
                "would corrupt the sidecar; use a fresh directory"
            )
        meta = {**prior, **meta}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)


def cmd_info(args) -> None:
    from . import __version__
    from .config import PRESET_NAMES, get_preset_config
    from .models.dit import dit_param_count

    device = _device(args)
    info = {
        "version": __version__,
        "backend": device.type,
        "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "presets": {
            name: {
                "latent_shape": list(get_preset_config(name).latent_shape),
                "params_b": round(dit_param_count(get_preset_config(name).net) / 1e9, 3),
            }
            for name in PRESET_NAMES
        },
    }
    print(json.dumps(info, indent=2))


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser: the same commands, options, defaults,
    choices and required flags."""
    p = argparse.ArgumentParser(prog="diffusionrenderer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--checkpoint", default=None,
                        help="DiT checkpoint (.pt/.safetensors or a native file); "
                             "random init if omitted")
        sp.add_argument("--vae", default=None,
                        help="VAE checkpoint dir/file; random init if omitted")
        sp.add_argument("--guidance", type=float, default=0.0)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--steps", type=int, default=15)
        sp.add_argument("--int8", action="store_true",
                        help="weight-only int8 quantization on load")
        sp.add_argument("--w8a8", action="store_true",
                        help="int8 weights + runtime int8 activations "
                             "(the int8 tensor-core matmul kernel; small accuracy cost)")
        sp.add_argument("--quant-group", dest="quant_group", type=int,
                        default=None, metavar="N",
                        help="per-group int8 weight scales over N input rows "
                             "(accuracy-preserving mode; default per-channel)")
        sp.add_argument("--quant-keep-bf16", dest="quant_keep_bf16",
                        default=None, metavar="NAMES",
                        help="comma-separated matmul names kept bf16 under "
                             "--int8/--w8a8 (e.g. 'wo,w2')")
        sp.add_argument("--tiny", action="store_true",
                        help="scaled-down random model (plumbing smoke test)")

    si = sub.add_parser("inverse", help="RGB video -> G-buffers")
    common(si)
    si.add_argument("--input", nargs="+", required=True, help="frame image(s)")
    si.add_argument("--output-dir", required=True)
    si.add_argument("--passes",
                    default="basecolor,metallic,roughness,normal,depth")
    si.add_argument("--resume-dir", dest="resume_dir", default=None,
                    help="directory for per-pass durability: finished "
                         "passes are saved here and a re-run after "
                         "preemption computes only the missing ones")
    si.set_defaults(fn=cmd_inverse)

    sf = sub.add_parser("forward", help="G-buffers + HDR env -> RGB")
    common(sf)
    for g in ("depth", "normal", "roughness", "metallic", "basecolor"):
        sf.add_argument(f"--{g}", nargs="+", required=True)
    sf.add_argument("--env", required=True)
    sf.add_argument("--output", required=True)
    sf.add_argument("--env-format", dest="env_format", default="proj",
                    choices=["proj", "proj_direct", "ball"])
    sf.add_argument("--env-brightness", type=float, default=1.0)
    sf.add_argument("--env-flip", action="store_true")
    sf.add_argument("--env-rotation", type=float, default=180.0)
    sf.set_defaults(fn=cmd_forward)

    se = sub.add_parser("envmap", help="preprocess an HDR panorama")
    se.add_argument("--input", required=True)
    se.add_argument("--height", type=int, required=True)
    se.add_argument("--width", type=int, required=True)
    se.add_argument("--output-prefix", required=True)
    se.add_argument("--env-brightness", type=float, default=1.0)
    se.add_argument("--env-flip", action="store_true")
    se.add_argument("--env-rotation", type=float, default=180.0)
    se.add_argument("--direct", action="store_true")
    se.set_defaults(fn=cmd_envmap)

    sc = sub.add_parser(
        "convert",
        help="reference checkpoints -> the port's native files (convert once, "
             "load fast; quantization baked in)",
    )
    sc.add_argument("--dit", default=None,
                    help="DiT checkpoint (.pt/.safetensors)")
    sc.add_argument("--vae", default=None,
                    help="VAE checkpoint (diffusers dir/safetensors)")
    sc.add_argument("--model-type", dest="model_type", default="inverse",
                    choices=["inverse", "forward"])
    sc.add_argument("--int8", action="store_true",
                    help="bake weight-only int8 quantization")
    sc.add_argument("--w8a8", action="store_true",
                    help="bake int8 weights + runtime-int8-activation marks")
    sc.add_argument("--quant-group", dest="quant_group", type=int,
                    default=None, metavar="N",
                    help="per-group int8 weight scales over N input rows")
    sc.add_argument("--quant-keep-bf16", dest="quant_keep_bf16",
                    default=None, metavar="NAMES",
                    help="comma-separated matmul names kept bf16 (e.g. 'wo,w2')")
    sc.add_argument("--tiny", action="store_true",
                    help="tiny architecture (matching --tiny checkpoints)")
    sc.add_argument("--skip-calibration", dest="skip_calibration",
                    action="store_true",
                    help="skip the VAE constant-frame roundtrip convention "
                         "check (only sensible for untrained weights)")
    sc.add_argument("--out", required=True, help="output directory")
    sc.set_defaults(fn=cmd_convert)

    so = sub.add_parser("info", help="environment + preset info")
    so.set_defaults(fn=cmd_info)

    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card; "
                        "without one every command raises)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
