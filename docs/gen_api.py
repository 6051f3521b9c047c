"""Generate docs/api.md — the full API reference — from live docstrings.

Mirrors the reference's Sphinx fullapi tree (reference doc/fullapi/:
api_analysis, api_estimation, api_neighbors, api_diffusion,
api_serialization, api_cli_logic, api_cli_internals, cliapi) as one
markdown page per the repo's docs-as-markdown convention.

Run from the repo root:  python docs/gen_api.py
"""
import importlib
import inspect
import io
import os
import sys

SECTIONS = [
    ("Analysis", ["velocyto_tpu.analysis"],
     "The estimation pipeline: VelocytoLoom and its helpers "
     "(reference doc/fullapi/api_analysis.rst)."),
    ("Estimation kernels", ["velocyto_tpu.estimation",
                            "velocyto_tpu.ops.coldeltacor",
                            "velocyto_tpu.ops.gamma",
                            "velocyto_tpu.ops.smoothing",
                            "velocyto_tpu.ops.pca"],
     "colDeltaCor and the gamma-fit / smoothing / PCA numeric kernels "
     "(reference doc/fullapi/api_estimation.rst)."),
    ("Neighbors", ["velocyto_tpu.ops.knn", "velocyto_tpu.ops.knn_device"],
     "Balanced kNN: host reference implementation and the device "
     "chain (reference doc/fullapi/api_neighbors.rst)."),
    ("Diffusion", ["velocyto_tpu.diffusion"],
     "Markov diffusion on the embedding "
     "(reference doc/fullapi/api_diffusion.rst)."),
    ("Serialization", ["velocyto_tpu.serialization",
                       "velocyto_tpu.io.loom",
                       "velocyto_tpu.io.checkpoint"],
     "HDF5 snapshots, loom I/O, and sharded-array checkpoints "
     "(reference doc/fullapi/api_serialization.rst)."),
    ("Counting logic", ["velocyto_tpu.counting.logics"],
     "The seven counting logics (reference doc/fullapi/api_cli_logic.rst)."),
    ("Counting internals", ["velocyto_tpu.counting.counter",
                            "velocyto_tpu.counting.gtf",
                            "velocyto_tpu.counting.reads",
                            "velocyto_tpu.counting.molecules",
                            "velocyto_tpu.counting.features",
                            "velocyto_tpu.counting.soa_engine",
                            "velocyto_tpu.counting.fastio",
                            "velocyto_tpu.counting.bamio",
                            "velocyto_tpu.counting.threeprime",
                            "velocyto_tpu.counting.dump"],
     "ExInCounter, the genomic model, and the SoA fast path "
     "(reference doc/fullapi/api_cli_internals.rst)."),
    ("CLI commands", ["velocyto_tpu.commands.run",
                      "velocyto_tpu.commands.run10x",
                      "velocyto_tpu.commands.run_smartseq2",
                      "velocyto_tpu.commands.run_dropest",
                      "velocyto_tpu.commands._run"],
     "The velocyto command group (reference doc/fullapi/cliapi.rst)."),
    ("Parallel / multi-chip", ["velocyto_tpu.parallel.mesh",
                               "velocyto_tpu.parallel.counts",
                               "velocyto_tpu.parallel.feeders"],
     "Device meshes, count merging, and feeder orchestration "
     "(no reference counterpart)."),
    ("Native runtime", ["velocyto_tpu.native"],
     "The C++ host runtime: BGZF/BAM decode, tag sort + .vtx index, "
     "record-boundary scan, MT19937 replay, balanced-kNN loop."),
    ("Utilities", ["velocyto_tpu.metadata", "velocyto_tpu.constants",
                   "velocyto_tpu.utils.rds",
                   "velocyto_tpu.utils.tenx_indexes",
                   "velocyto_tpu.utils.profiling"],
     "Metadata tables, constants, the R-free RDS reader, profiling."),
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _first_para(doc) -> str:
    if not doc:
        return ""
    doc = inspect.cleandoc(doc)
    return doc.split("\n\n")[0].replace("\n", " ")


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue                      # re-exports documented at home
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    buf = io.StringIO()
    w = buf.write
    w("# velocyto_tpu API reference\n\n")
    w("Generated from live docstrings by `python docs/gen_api.py` — "
      "regenerate after signature changes.  Section layout mirrors the "
      "reference's Sphinx fullapi tree.\n")
    for title, mods, blurb in SECTIONS:
        w(f"\n## {title}\n\n{blurb}\n")
        for modname in mods:
            mod = importlib.import_module(modname)
            w(f"\n### `{modname}`\n\n")
            mdoc = _first_para(mod.__doc__)
            if mdoc:
                w(mdoc + "\n")
            for name, obj in _public_members(mod):
                if inspect.isclass(obj):
                    w(f"\n#### class `{name}{_sig(obj)}`\n\n")
                    w(_first_para(obj.__doc__) + "\n")
                    for mn, m in inspect.getmembers(obj):
                        if mn.startswith("_") or not (
                                inspect.isfunction(m) or
                                inspect.ismethod(m)):
                            continue
                        if m.__qualname__.split(".")[0] != name:
                            continue      # inherited
                        w(f"- `{mn}{_sig(m)}` — {_first_para(m.__doc__)}\n")
                else:
                    w(f"\n**`{name}{_sig(obj)}`** — "
                      f"{_first_para(obj.__doc__)}\n")
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "api.md")
    with open(out_path, "w") as f:
        f.write(buf.getvalue())
    print(f"wrote {out_path} ({len(buf.getvalue())} bytes)")


if __name__ == "__main__":
    main()
