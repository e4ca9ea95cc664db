from .api import ModelBundle, build
