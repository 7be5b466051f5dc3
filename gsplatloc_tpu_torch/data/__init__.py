"""Data layer: Replica/TUM loaders, frame-pair parser, synthetic scenes."""
