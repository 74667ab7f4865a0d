"""``python -m tracer_torch.bench``: the headline JSON line on a CUDA card."""

from tracer_torch.bench.headline import main

if __name__ == "__main__":
    raise SystemExit(main())
