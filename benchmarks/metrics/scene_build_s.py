"""Seconds of the program's scene build (host clock around the build call)."""


def read(ctx):
    return ctx.scene_build_s
