"""The port's benchmark: cells of `BENCHMARK.json` run against
`deepmatching_stereo_matching_tpu_torch` on one CUDA card
(`python -m stereobench.run`)."""
