"""scene_load_s: host seconds of `load_scene(path)` (layer: scene host)."""


def read(record):
    return record.get("scene_load_s")
