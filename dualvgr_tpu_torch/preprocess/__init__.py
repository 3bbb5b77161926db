"""Offline preprocessing: question pickles and vocab, and clip features from raw video."""
