"""``python -m repro_torch.obs TRACE.jsonl`` — the explainer CLI (same flags
as ``repro_torch.obs.explain``; this alias avoids runpy's package-reimport
warning when the package is already imported)."""
from .explain import main

if __name__ == "__main__":
    raise SystemExit(main())
