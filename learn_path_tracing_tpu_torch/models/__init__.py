from .scenes import (
    random_scene,
    stage10_camera,
    stage3_scene,
    stage4_scene,
    stage6_scene,
    stage7_scene,
    stage8_scene,
)

__all__ = [
    "random_scene",
    "stage10_camera",
    "stage3_scene",
    "stage4_scene",
    "stage6_scene",
    "stage7_scene",
    "stage8_scene",
]
