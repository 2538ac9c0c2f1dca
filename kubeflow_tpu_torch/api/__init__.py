"""The port's API types: the Notebook CR and the SlicePool CR."""

from .types import (API_VERSION, GROUP, KIND, SERVED_VERSIONS,
                    STORAGE_VERSION, new_notebook, notebook_container,
                    parse_version, validate_notebook)

__all__ = ["API_VERSION", "GROUP", "KIND", "SERVED_VERSIONS",
           "STORAGE_VERSION", "new_notebook", "notebook_container",
           "parse_version", "validate_notebook"]
