"""set_scene_s: host seconds of `set_scene`, closed by a device
synchronize (layer: scene tables)."""


def read(record):
    return record.get("set_scene_s")
