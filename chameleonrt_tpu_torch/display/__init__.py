from chameleonrt_tpu_torch.display.display import (  # noqa: F401
    AnsiDisplay,
    Display,
    PngSequenceDisplay,
    make_display,
)


def __getattr__(name):  # lazy: http_display pulls in http.server machinery
    if name == "HttpDisplay":
        from chameleonrt_tpu_torch.display.http_display import HttpDisplay

        return HttpDisplay
    raise AttributeError(name)
