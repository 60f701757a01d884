from .models import CurveAccessor, Model
