"""Scripts of the port, each run as ``python -m cds_mvsnet_tpu_torch.tools.<name>``:
measurements on the card (``time_warp``, ``time_epipole``), the probes'
entry points (``probe_lane_slice``, P1; ``probe_gather16``, P2; on the card
unless ``main(device="cpu")``), the COLMAP converter (``colmap2mvs``,
host only), and the JAX package's tools of the same names at their points
(``profile_stages``, ``bench_scan``, ``bench_train``, ``train_convergence``,
``convert_checkpoint``; on the card unless ``main(device="cpu")``)."""
