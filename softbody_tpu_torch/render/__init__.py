"""PBRT scene writers, frame adapters, video export and the matplotlib
preview (host numpy; matplotlib and imageio are imported lazily)."""
