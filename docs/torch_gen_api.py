"""Generate docs/torch-api-reference.md from the public surface of ``pyorc_tpu_torch``.

Run:  python docs/torch_gen_api.py          (rewrites docs/torch-api-reference.md)

The port's flat markdown API page: every public class, accessor method and
module-level function with its signature and the first line of its
docstring, and for methods a YAML recipe reaches, the recipe section and key
that dispatch to it (``cli/cli_utils.py::validate_recipe`` checks recipe keys
against these very signatures). It imports the port only, never JAX or
``pyorc_tpu``. ``tests/test_torch_docs.py`` regenerates the page and fails
when the committed copy is stale.
"""

import importlib
import inspect
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch-api-reference.md")

# (title, module, class or None, recipe column or None, intro); the recipe
# column is a format string with {name}, or None where the section's keys are
# not method calls (`video:` keys are Video CONSTRUCTOR arguments)
CLASS_SECTIONS = [
    ("Video", "pyorc_tpu_torch.api.video", "Video", None,
     "Opens a video file with a camera configuration; decode runs on the host (the port's FFmpeg pump, or "
     "OpenCV), and frames come out as a lazy labeled array. The recipe `video:` section supplies the CONSTRUCTOR "
     "arguments (start_frame, end_frame, h_a, ...), not method calls."),
    ("LazyFrames", "pyorc_tpu_torch.api.video", "LazyFrames", None,
     "Frames decoded on demand in batches; a view with ops uploads each batch once and runs its filters and "
     "projection on the device. `read_batch` gives a device tensor, `read_batch_np` host numpy."),
    ("CameraConfig", "pyorc_tpu_torch.api.cameraconfig", "CameraConfig", None,
     "The geometric core: intrinsics, pose, GCPs, CRS, water levels, AOI and the ortho grid (host float64)."),
    ("CrossSection", "pyorc_tpu_torch.api.cross_section", "CrossSection", None,
     "3-D cross-section geometry, wetted surfaces and optical water-level detection "
     "(driven by the recipe `water_level:` section via the service layer)."),
    ("Frames accessor (`da.frames`)", "pyorc_tpu_torch.api.frames", "Frames",
     "frames: {{{name}: ...}}",
     "Preprocessing filters, orthorectification, PIV (the CUDA kernels) and STIV on a frames DataArray."),
    ("Velocimetry accessor (`ds.velocimetry`)", "pyorc_tpu_torch.api.velocimetry", "Velocimetry",
     "velocimetry: {{{name}: ...}}",
     "Validity checks, transect sampling, masking entry point and writers on a PIV Dataset."),
    ("Mask methods (`ds.velocimetry.mask.*`)", "pyorc_tpu_torch.api.mask", "_Velocimetry_MaskMethods",
     "mask: {{<group>: {{{name}: ...}}}}",
     "Composable vector-field filters; recipe `mask:` groups list them by name."),
    ("Transect accessor (`ds.transect`)", "pyorc_tpu_torch.api.transect", "Transect",
     "transect: {{<name>: {{{name}: ...}}}}",
     "Effective velocities, depth-integrated q, river discharge on sampled cross-sections."),
    ("Plot accessors (`.velocimetry.plot` / `.transect.plot` / `.frames.plot`)",
     "pyorc_tpu_torch.api.plot", None, None,
     "Quiver/scatter/pcolormesh/streamplot in local, geographical or camera perspective "
     "(host matplotlib; recipe `plot:` sections compose these per figure)."),
]

MODULE_SECTIONS = [
    ("Top-level package", "pyorc_tpu_torch",
     "`Video`, `LazyFrames`, `CameraConfig`, `CrossSection`, `load_camera_config`, `open_dataset`, labeled "
     "arrays, and the device: `set_device`, `get_device`, `apply_device_override`."),
    ("Device and copies", "pyorc_tpu_torch._device",
     "The device every op runs on (CUDA by default; `PYORC_TPU_TORCH_DEVICE`), the mesh's devices, and the "
     "counted host<->device copies."),
    ("Service layer", "pyorc_tpu_torch.service.velocimetry",
     "Recipe-driven end-to-end pipeline (`velocity_flow`), stage cache, subprocess embedding."),
    ("Camera-config service", "pyorc_tpu_torch.service.camera_config",
     "Builds a CameraConfig from a video + GCPs and writes overview figures."),
    ("IO writers", "pyorc_tpu_torch.io",
     "GeoTIFF, UGRID (QGIS mesh), netCDF with CF int16/scale encoding, the native FFmpeg decode pump."),
    ("Geometry helpers", "pyorc_tpu_torch.helpers",
     "Affine/CRS transforms, equidistant resampling, log-profile fits, discharge integration."),
    ("PIV ops", "pyorc_tpu_torch.ops.piv",
     "The plain PyTorch PIV pipeline (the JAX package's XLA semantics): windowed cross-correlation by "
     "`torch.fft` or the DFT as matrix products (`corr_method`), row-band strips, subpixel peaks, the ensemble "
     "scan. The plain route and the kernels' reference."),
    ("CUDA kernels", "pyorc_tpu_torch.ops.piv_kernels",
     "The hand-written per-pair and ensemble kernels (`csrc/*.cu`), their plain versions, the route plan and "
     "the JAX package's engine names."),
    ("Multipass PIV", "pyorc_tpu_torch.ops.multipass",
     "Coarse-to-fine window deformation PIV with the normalized median test between passes; the deformation "
     "is the hand-written `deform_pairs` kernel (`csrc/deform.cu`) on the card."),
    ("STIV ops", "pyorc_tpu_torch.ops.stiv",
     "Space-time image velocimetry: batched line sampling + structure-tensor streak angles."),
    ("Multi-device parallel", "pyorc_tpu_torch.parallel.piv",
     "PIV over a mesh of devices: pair shards with the kernels' halo, (pairs, rows) slabs, the ensemble's sums "
     "added in shard order."),
    ("Multi-host", "pyorc_tpu_torch.parallel.distributed",
     "Segments of one video split across hosts (gloo), the barrier and the manifest."),
    ("Sample data", "pyorc_tpu_torch.sample_data",
     "Zenodo dataset fetchers for the Hommerich example."),
]


def _sig(obj):
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    return s if len(s) <= 100 else s[:97] + "...)"


def _doc1(obj):
    d = inspect.getdoc(obj)
    return d.strip().splitlines()[0].rstrip() if d else ""


def _public_methods(cls):
    for name, fn in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(fn, property):
            yield name, fn.fget, True
        elif callable(fn):
            yield name, fn, False


def _class_block(lines, mod, clsname, recipe):
    cls = getattr(importlib.import_module(mod), clsname)
    for name, fn, is_prop in _public_methods(cls):
        sig = "" if is_prop else f"`{_sig(fn)}`"
        rec = f" — recipe: `{recipe.format(name=name)}`" if recipe and not is_prop else ""
        lines.append(f"- **`{name}`** ({'property' if is_prop else 'method'}) {sig}{rec}")
        doc = _doc1(fn)
        if doc:
            lines.append(f"  {doc}")


def _module_block(lines, mod):
    m = importlib.import_module(mod)
    names = getattr(m, "__all__", None) or [
        n for n, o in sorted(vars(m).items())
        if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
        and getattr(o, "__module__", None) == mod
    ]
    for n in sorted(names):
        o = getattr(m, n, None)
        if o is None or inspect.ismodule(o):
            continue
        if inspect.isclass(o):
            lines.append(f"- **`{n}`** (class) `{_sig(o)}`")
        elif callable(o):
            lines.append(f"- **`{n}`** `{_sig(o)}`")
        else:
            lines.append(f"- **`{n}`**")
            continue
        doc = _doc1(o)
        if doc:
            lines.append(f"  {doc}")


def generate() -> str:
    lines = [
        "# pyorc_tpu_torch API reference",
        "",
        "Generated by `docs/torch_gen_api.py` — do not edit by hand "
        "(`python docs/torch_gen_api.py` refreshes it; `tests/test_torch_docs.py` enforces freshness).",
        "",
        "The PyTorch/CUDA port of `pyorc_tpu` (see `docs/torch-user-guide.md`). Recipe annotations show how a",
        "method is reached from a YAML recipe: the section name maps to a pipeline stage and the key inside it",
        "to the method (validated against these signatures by `validate_recipe`).",
        "",
    ]
    for title, mod, clsname, recipe, intro in CLASS_SECTIONS:
        lines += [f"## {title}", "", intro, ""]
        if clsname is not None:
            _class_block(lines, mod, clsname, recipe)
        else:
            m = importlib.import_module(mod)
            for plot_cls in ["_Velocimetry_PlotMethods", "_Transect_PlotMethods", "_Frames_PlotMethods"]:
                if getattr(m, plot_cls, None) is None:
                    continue
                lines.append(f"### `.{plot_cls.split('_')[1].lower()}.plot`")
                _class_block(lines, mod, plot_cls, None)
        lines.append("")
    lines += ["# Modules", ""]
    for title, mod, intro in MODULE_SECTIONS:
        lines += [f"## {title} (`{mod}`)", "", intro, ""]
        _module_block(lines, mod)
        lines.append("")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repository root
    text = generate()
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}: {text.count(chr(10) + '- ')} entries, {len(text.splitlines())} lines")
    sys.exit(0)
