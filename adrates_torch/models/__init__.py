from .models import CurveAccessor, Model
from .serialization import model_from_json, model_to_json
