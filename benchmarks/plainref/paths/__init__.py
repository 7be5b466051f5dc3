"""One plain reference per tracking path, found by the path's name
(`harness.tracking_path`): `<path>.py` with `track_pair(tar_depth,
tar_c2w, src_depth, src_c2w, K, config, device)` returning the pair's
`best_c2w`, `steps` and `selects` (`pair.result`)."""
